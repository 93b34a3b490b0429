"""The port's consensus types held against the JAX package's on the same
seeded inputs, exactly: the message codec, `Proposal`, `Heartbeat`,
`Vote`, `DuplicateVoteEvidence`, tx-index records and the priv-validator
file, byte for byte both ways; one seeded sequence of votes through both
`VoteSet`s and both `HeightVoteSet`s (conflicts, peer majority claims,
nil votes, wrong heights, bad indices, bad signatures) with the same
outcome, sums, bit arrays, two-thirds answers and commit bytes;
`add_votes_batched` on the plain K1 against the JAX package's python
backend, forged lanes mixed in."""

import random

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from tendermint_tpu.abci.types import Result as JResult
from tendermint_tpu.consensus import messages as JM
from tendermint_tpu.consensus.height_vote_set import (
    HeightVoteSet as JHeightVoteSet)
from tendermint_tpu.crypto import backend as jcb
from tendermint_tpu.state import evidence as jevidence
from tendermint_tpu.state import txindex as jtxindex
from tendermint_tpu.types import PrivKey as JPrivKey
from tendermint_tpu.types.codec import Reader as JReader
from tendermint_tpu.types.priv_validator import PrivValidator as JPrivValidator
from tendermint_tpu.types.proposal import (Heartbeat as JHeartbeat,
                                           Proposal as JProposal)
from tendermint_tpu.types.vote import (DuplicateVoteEvidence as JDuplicate,
                                       Vote as JVote, VoteSet as JVoteSet)
from tendermint_tpu.utils.db import MemDB as JMemDB
from tendermint_tpu_torch.abci.types import Result
from tendermint_tpu_torch.batchplane import BatchPlane
from tendermint_tpu_torch.consensus import messages as M
from tendermint_tpu_torch.consensus.height_vote_set import HeightVoteSet
from tendermint_tpu_torch.crypto import pure_ed25519 as ref
from tendermint_tpu_torch.crypto.backend import CudaBackend, PythonBackend
from tendermint_tpu_torch.state import txindex
from tendermint_tpu_torch.types import merkle
from tendermint_tpu_torch.types import (Block, BlockID, Part, PartSetHeader,
                                        PrivKey, PubKey, TYPE_PRECOMMIT,
                                        TYPE_PREVOTE, Validator,
                                        ValidatorSet, ZERO_BLOCK_ID)
from tendermint_tpu_torch.types.codec import Reader, lp_bytes
from tendermint_tpu_torch.types.priv_validator import PrivValidator
from tendermint_tpu_torch.types.proposal import Heartbeat, Proposal
from tendermint_tpu_torch.types.vote import (DuplicateVoteEvidence,
                                             ErrVoteConflict, Vote, VoteSet)
from tendermint_tpu_torch.utils.db import MemDB

from torch_chains import jax_vals, share_cores

CHAIN = "votes-chain"
SEEDS = [bytes([9, i + 1]) + bytes(30) for i in range(6)]
POWERS = [10, 20, 5, 30, 25]            # uneven; 90 in all, so exactly
#                                         2/3 (60) is reachable
BLOCKS = {
    "A": BlockID(b"\xaa" * 32, PartSetHeader(1, b"\xa1" * 32)),
    "B": BlockID(b"\xbb" * 32, PartSetHeader(2, b"\xb2" * 32)),
    "nil": ZERO_BLOCK_ID,
}


@pytest.fixture(autouse=True)
def _jax_python_backend():
    old = jcb._current
    jcb.set_backend("python")
    yield
    jcb._current = old


def _vals(n=len(POWERS)) -> ValidatorSet:
    return ValidatorSet([Validator(PubKey(ref.pubkey_from_seed(s)), p)
                         for s, p in zip(SEEDS, POWERS[:n])])


VALS = _vals()
JVALS = jax_vals(VALS)
SEED_OF = {PubKey(ref.pubkey_from_seed(s)).address: s for s in SEEDS}
# the sixth key signs but is in no set: a stranger
STRANGER = PubKey(ref.pubkey_from_seed(SEEDS[5])).address
_SIGS: dict = {}


def _jvote(v: Vote) -> JVote:
    return JVote.decode(JReader(v.encode()))


def _vote(val: int, height: int, round_: int, type_: int, block: str,
          bad_sig: bool = False, index: int | None = None) -> Vote:
    """Validator `val`'s (of VALS, or the stranger at 5) signed vote;
    `index` overrides its validator index (a bad index)."""
    addr = VALS.validators[val].address if val < VALS.size() else STRANGER
    v = Vote(addr, val if index is None else index, height, round_, type_,
             BLOCKS[block])
    key = (addr, height, round_, type_, block)
    sig = _SIGS.get(key)
    if sig is None:
        sig = _SIGS[key] = ref.sign(SEED_OF[addr], v.sign_bytes(CHAIN))
    if bad_sig:
        sig = bytes([sig[0] ^ 0x40]) + sig[1:]
    return Vote(**{**v.__dict__, "signature": sig})


def _outcome(fn):
    """A call's result, or its error as comparable data (evidence as
    bytes)."""
    try:
        return ("ok", fn())
    except ErrVoteConflict as e:
        ev = e.evidence
        return ("conflict", ev.vote_a.encode(), ev.vote_b.encode())
    except Exception as e:
        if type(e).__name__ == "ErrVoteConflict":      # the JAX package's
            ev = e.evidence
            return ("conflict", ev.vote_a.encode(), ev.vote_b.encode())
        return ("err", type(e).__name__, str(e))


def _bid(b):
    return None if b is None else b.encode()


def _vs_state(vs) -> tuple:
    per_block = tuple(tuple(vs.bit_array_by_block_id(b))
                      for b in BLOCKS.values())
    return (vs.sum(), tuple(vs.bit_array()), per_block,
            vs.has_two_thirds_majority(), _bid(vs.two_thirds_majority()),
            vs.has_two_thirds_any(), vs.has_one_third_any(), vs.has_all(),
            str(vs),
            tuple(None if vs.get_by_index(i) is None
                  else vs.get_by_index(i).encode()
                  for i in range(vs.size())))


def _random_op(rng: random.Random, h: int, r: int, t: int) -> tuple:
    """One seeded op on a vote set at (h, r, t)."""
    x = rng.random()
    if x < 0.12:
        return ("maj23", rng.choice(["p1", "p2", "p3"]),
                rng.choice(list(BLOCKS)))
    val = rng.randrange(VALS.size())
    height, round_, type_ = h, r, t
    index = None
    y = rng.random()
    if y < 0.06:
        height = h + rng.choice([-1, 1])
    elif y < 0.10:
        round_ = r + 1
    elif y < 0.14:
        type_ = TYPE_PREVOTE + TYPE_PRECOMMIT - t
    elif y < 0.18:
        index = rng.choice([VALS.size(), (val + 1) % VALS.size()])
    elif y < 0.20:
        val = VALS.size()                          # the stranger
    block = rng.choices(list(BLOCKS), weights=[5, 3, 2])[0]
    return ("vote", val, max(1, height), round_, type_, block,
            rng.random() < 0.08, index)


def _apply(op, vs, jvs, verify=True):
    if op[0] == "maj23":
        b = BLOCKS[op[2]]
        jb = _jvote(Vote(b"\0" * 20, 0, 1, 0, 1, b)).block_id
        return (_outcome(lambda: vs.set_peer_maj23(op[1], b)),
                _outcome(lambda: jvs.set_peer_maj23(op[1], jb)))
    v = _vote(*op[1:])
    jv = _jvote(v)
    return (_outcome(lambda: vs.add_vote(v, verify=verify)),
            _outcome(lambda: jvs.add_vote(jv, verify=verify)))


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 2**32 - 1), type_=st.sampled_from(
    [TYPE_PREVOTE, TYPE_PRECOMMIT]))
def test_vote_set_sequence_matches_reference(seed, type_):
    rng = random.Random(seed)
    vs = VoteSet(CHAIN, 3, 1, type_, VALS)
    jvs = JVoteSet(CHAIN, 3, 1, type_, JVALS)
    for _ in range(40):
        op = _random_op(rng, 3, 1, type_)
        got, want = _apply(op, vs, jvs)
        assert got == want, op
        assert _vs_state(vs) == _vs_state(jvs), op
    got = _outcome(lambda: vs.make_commit().encode())
    want = _outcome(lambda: jvs.make_commit().encode())
    assert got == want


def test_vote_set_commit_and_conflicts():
    """A deterministic walk: a +2/3 for A formed in part by a conflicting
    vote a peer's majority claim let in, then make_commit on both."""
    vs = VoteSet(CHAIN, 2, 0, TYPE_PRECOMMIT, VALS)
    jvs = JVoteSet(CHAIN, 2, 0, TYPE_PRECOMMIT, JVALS)
    # the weakest validator votes nil, the others A (> 2/3 of the power)
    powers = [v.voting_power for v in VALS.validators]
    weak = powers.index(min(powers))
    a, b, c, d = (i for i in range(VALS.size()) if i != weak)
    ops = [("vote", a, 2, 0, TYPE_PRECOMMIT, "B", False, None),
           ("vote", a, 2, 0, TYPE_PRECOMMIT, "A", False, None),  # conflict
           ("maj23", "p1", "A"),
           ("vote", a, 2, 0, TYPE_PRECOMMIT, "A", False, None),  # counts
           ("vote", b, 2, 0, TYPE_PRECOMMIT, "A", False, None),
           ("vote", b, 2, 0, TYPE_PRECOMMIT, "A", False, None),  # dup
           ("vote", c, 2, 0, TYPE_PRECOMMIT, "A", True, None),   # bad sig
           ("vote", c, 2, 0, TYPE_PRECOMMIT, "A", False, None),
           ("vote", d, 2, 0, TYPE_PRECOMMIT, "A", False, None),
           ("vote", weak, 2, 0, TYPE_PRECOMMIT, "nil", False, None),
           ("maj23", "p1", "B")]                      # conflicting claim
    outcomes = []
    for op in ops:
        got, want = _apply(op, vs, jvs)
        assert got == want, op
        assert _vs_state(vs) == _vs_state(jvs), op
        outcomes.append(got[0])
    assert outcomes[1] == "conflict" and outcomes[6] == "err"
    assert vs.has_two_thirds_majority()
    assert vs.make_commit().encode() == jvs.make_commit().encode()


@settings(max_examples=15, deadline=None)
@given(seed=st.integers(0, 2**32 - 1))
def test_height_vote_set_sequence_matches_reference(seed):
    rng = random.Random(seed)
    hvs = HeightVoteSet(CHAIN, 4, VALS)
    jhvs = JHeightVoteSet(CHAIN, 4, JVALS)
    for _ in range(50):
        x = rng.random()
        if x < 0.08:
            r = rng.randrange(4)
            hvs.set_round(r)
            jhvs.set_round(r)
        elif x < 0.16:
            r, t = rng.randrange(6), rng.choice([1, 2])
            peer, b = rng.choice(["p1", "p2"]), rng.choice(list(BLOCKS))
            jb = _jvote(Vote(b"\0" * 20, 0, 1, 0, 1, BLOCKS[b])).block_id
            got = _outcome(lambda: hvs.set_peer_maj23(r, t, peer,
                                                      BLOCKS[b]))
            want = _outcome(lambda: jhvs.set_peer_maj23(r, t, peer, jb))
            assert got == want
        else:
            # rounds up to 6 ahead: the peers' catchup-round quota
            r = rng.randrange(7)
            op = _random_op(rng, 4, r, rng.choice([1, 2]))
            if op[0] == "maj23":
                continue
            v = _vote(*op[1:])
            peer = rng.choice(["p1", "p2", "p3"])
            verify = rng.random() < 0.8
            got = _outcome(lambda: hvs.add_vote(v, peer, verify=verify))
            want = _outcome(lambda: jhvs.add_vote(_jvote(v), peer,
                                                  verify=verify))
            assert got == want, op
        assert hvs.round() == jhvs.round()
        got_pol, want_pol = hvs.pol_info(), jhvs.pol_info()
        assert (got_pol is None) == (want_pol is None)
        if got_pol is not None:
            assert (got_pol[0], got_pol[1].encode()) == \
                (want_pol[0], want_pol[1].encode())
        for r in range(8):
            for get, jget in ((hvs.prevotes, jhvs.prevotes),
                              (hvs.precommits, jhvs.precommits)):
                a, b = get(r), jget(r)
                assert (a is None) == (b is None)
                if a is not None:
                    assert _vs_state(a) == _vs_state(b)


def _batch_votes() -> list:
    """Four validators' precommits for A at (2, 0), mixed with forged,
    malformed, off-height, off-set and conflicting votes."""
    votes = [_vote(i, 2, 0, TYPE_PRECOMMIT, "A") for i in range(4)]
    forged = _vote(1, 2, 0, TYPE_PRECOMMIT, "B", bad_sig=True)
    short = Vote(**{**votes[2].__dict__, "signature": b"\x01" * 63})
    return [votes[0], forged, votes[1], short,
            _vote(2, 3, 0, TYPE_PRECOMMIT, "A"),        # wrong height
            _vote(4, 2, 0, TYPE_PRECOMMIT, "A", index=2),  # bad index
            votes[2], votes[3], _vote(3, 2, 0, TYPE_PRECOMMIT, "B"),
            _vote(0, 2, 0, TYPE_PRECOMMIT, "A", bad_sig=True),
            votes[0]]


@pytest.mark.parametrize("backend", ["plain K1", "python"])
def test_add_votes_batched_matches_reference(backend):
    """`add_votes_batched` through a `BatchPlane` on the plain K1
    (`CudaBackend(device="cpu")`, four keys) and on the golden verifier,
    against the JAX package's on its python backend: the same outcome per
    vote, the same tally and the same commit."""
    vals = _vals(4)
    old = share_cores()
    be = CudaBackend(device="cpu") if backend == "plain K1" \
        else PythonBackend()
    plane = BatchPlane(be)
    try:
        votes = _batch_votes()
        vs = VoteSet(CHAIN, 2, 0, TYPE_PRECOMMIT, vals)
        jvs = JVoteSet(CHAIN, 2, 0, TYPE_PRECOMMIT, jax_vals(vals))
        got = [_outcome(lambda o=o: _raise(o))
               for o in vs.add_votes_batched(votes, plane)]
        want = [_outcome(lambda o=o: _raise(o))
                for o in jvs.add_votes_batched([_jvote(v) for v in votes])]
    finally:
        plane.stop()
        import torch
        torch.set_num_threads(old)
    assert got == want
    assert _vs_state(vs) == _vs_state(jvs)
    assert vs.make_commit().encode() == jvs.make_commit().encode()
    assert got.count(("ok", True)) == 4 and got[-1] == ("ok", False)


def _raise(o):
    if isinstance(o, Exception):
        raise o
    return o


def test_add_votes_batched_raises_a_plane_error():
    """No scalar fallback: a verify that fails on the plane raises out of
    `add_votes_batched`, and no vote is counted."""
    class Broken(PythonBackend):
        def verify_grouped(self, *a):
            raise RuntimeError("K1 launch failed")

    plane = BatchPlane(Broken())
    vs = VoteSet(CHAIN, 2, 0, TYPE_PRECOMMIT, VALS)
    try:
        with pytest.raises(RuntimeError, match="K1 launch failed"):
            vs.add_votes_batched(
                [_vote(i, 2, 0, TYPE_PRECOMMIT, "A") for i in range(4)],
                plane)
    finally:
        plane.stop()
    assert vs.sum() == 0 and not any(vs.bit_array())


# -- codecs ------------------------------------------------------------------

def _rand_bytes(rng, n):
    return bytes(rng.getrandbits(8) for _ in range(n))


def _messages(rng) -> list:
    bid = BlockID(_rand_bytes(rng, 32), PartSetHeader(rng.randrange(1, 9),
                                                      _rand_bytes(rng, 32)))
    psh = PartSetHeader(rng.randrange(1, 9), _rand_bytes(rng, 32))
    bits = tuple(rng.random() < 0.5 for _ in range(rng.randrange(0, 20)))
    vote = _vote(rng.randrange(5), rng.randrange(1, 99), rng.randrange(4),
                 rng.choice([1, 2]), rng.choice(list(BLOCKS)))
    prop = Proposal(rng.randrange(1, 99), rng.randrange(5), psh,
                    pol_round=rng.randrange(-1, 3),
                    pol_block_id=rng.choice([None, bid]),
                    signature=_rand_bytes(rng, 64))
    hb = Heartbeat(_rand_bytes(rng, 20), rng.randrange(-1, 100),
                   rng.randrange(1, 99), rng.randrange(5),
                   rng.randrange(2**40), _rand_bytes(rng, 64))
    part = Part(rng.randrange(8), _rand_bytes(rng, rng.randrange(1, 300)),
                merkle.Proof(rng.randrange(1, 9), rng.randrange(8),
                             _rand_bytes(rng, 32),
                             tuple(_rand_bytes(rng, 32)
                                   for _ in range(rng.randrange(4)))))
    h, r = rng.randrange(1, 2**40), rng.randrange(2**20)
    msgs = [M.ProposalMessage(prop), M.BlockPartMessage(h, r, part),
            M.VoteMessage(vote),
            M.NewRoundStepMessage(h, r, rng.randrange(1, 9),
                                  rng.randrange(1000), rng.randrange(-1, 5)),
            M.CommitStepMessage(h, rng.randrange(100), bits),
            M.HasVoteMessage(h, r, rng.choice([1, 2]), rng.randrange(100)),
            M.VoteSetMaj23Message(h, r, rng.choice([1, 2]), bid),
            M.VoteSetBitsMessage(h, r, rng.choice([1, 2]), bid, bits),
            M.ProposalPOLMessage(h, rng.randrange(-1, 5), bits),
            M.ProposalHeartbeatMessage(hb)]
    msgs.append(M.StampedMessage(rng.choice(msgs[:3]),
                                 sent_ts=rng.randrange(2**31) / 1e3,
                                 origin=rng.choice(["", "node7"])))
    return msgs


@pytest.mark.parametrize("seed", range(6))
def test_message_codec_matches_reference_both_ways(seed):
    for msg in _messages(random.Random(seed)):
        data = M.encode_msg(msg)
        jmsg = JM.decode_msg(data)
        assert type(jmsg).__name__ == type(msg).__name__
        assert JM.encode_msg(jmsg) == data
        assert M.encode_msg(M.decode_msg(JM.encode_msg(jmsg))) == data
        assert M.decode_msg(data) == msg


@pytest.mark.parametrize("seed", range(4))
def test_proposal_heartbeat_vote_codecs_and_sign_bytes(seed):
    rng = random.Random(seed)
    for m in _messages(rng)[:10]:
        obj = getattr(m, "proposal", None) or getattr(m, "heartbeat", None) \
            or getattr(m, "vote", None)
        if obj is None:
            continue
        jcls = {Proposal: JProposal, Heartbeat: JHeartbeat,
                Vote: JVote}[type(obj)]
        jobj = jcls.decode(JReader(obj.encode()))
        assert jobj.encode() == obj.encode()
        assert type(obj).decode(Reader(jobj.encode())) == obj
        # a heartbeat's sequence past u32 cannot sign: the same error
        assert _outcome(lambda: jobj.sign_bytes(CHAIN)) == \
            _outcome(lambda: obj.sign_bytes(CHAIN))
    assert M.decode_msg(M.encode_msg(M.ProposalHeartbeatMessage(
        Heartbeat(b"\x01" * 20, -1, 7, 2, 3, b"\x05" * 64)))).heartbeat \
        .validator_index == -1


def test_evidence_and_tx_index_codecs():
    """Equivocation evidence from the port's `VoteSet` on the JAX
    package's evidence wire form (two length-prefixed votes), both ways;
    then a tx-index record."""
    vs = VoteSet(CHAIN, 5, 0, TYPE_PREVOTE, VALS)
    vs.add_vote(_vote(0, 5, 0, TYPE_PREVOTE, "A"))
    with pytest.raises(ErrVoteConflict) as e:
        vs.add_vote(_vote(0, 5, 0, TYPE_PREVOTE, "B"))
    ev = e.value.evidence
    assert isinstance(ev, DuplicateVoteEvidence)
    jev = JDuplicate(_jvote(ev.vote_a), _jvote(ev.vote_b))
    data = lp_bytes(ev.vote_a.encode()) + lp_bytes(ev.vote_b.encode())
    assert data == jevidence.encode_evidence(jev)
    r = Reader(jevidence.encode_evidence(jev))
    assert DuplicateVoteEvidence(Vote.decode(Reader(r.lp_bytes())),
                                 Vote.decode(Reader(r.lp_bytes()))) == ev
    r.expect_done()
    assert jevidence.decode_evidence(data).vote_b.encode() == \
        ev.vote_b.encode()
    tr = txindex.TxResult(7, 3, b"k=v", Result(1, data=b"\x02", log="bad"))
    jtr = jtxindex.TxResult(7, 3, b"k=v", JResult(1, data=b"\x02",
                                                   log="bad"))
    assert tr.encode() == jtr.encode()
    assert txindex.TxResult.decode_bytes(jtr.encode()) == tr


def test_tx_indexer_rows_match_reference():
    from tendermint_tpu.state.state import ABCIResponses as JResponses
    from tendermint_tpu_torch.state.state import ABCIResponses
    txs = [b"a=1", b"b=2", b"c"]
    block = Block.make(CHAIN, 4, 5, txs, _commit_stub(), ZERO_BLOCK_ID,
                       b"\x01" * 32, b"")
    res = [Result(0, data=b"x"), Result(3, log="no"), Result(0)]
    db, jdb = MemDB(), JMemDB()
    txindex.KVTxIndexer(db).index_block(block, ABCIResponses(4, res))
    from tendermint_tpu.types import Block as JBlock
    jtxindex.KVTxIndexer(jdb).index_block(
        JBlock.decode_bytes(block.encode()),
        JResponses(4, [JResult(r.code, data=r.data, log=r.log)
                       for r in res]))
    assert list(db.iterate_prefix(b"")) == list(jdb.iterate_prefix(b""))
    from tendermint_tpu_torch.types.tx import Tx
    got = txindex.KVTxIndexer(db).get(Tx(b"b=2").hash)
    assert (got.height, got.index, got.tx, got.result.code) == \
        (4, 1, b"b=2", 3)
    assert txindex.NullTxIndexer().get(b"") is None


def _commit_stub():
    from tendermint_tpu_torch.types import EMPTY_COMMIT
    return EMPTY_COMMIT


def test_priv_validator_file_is_byte_compatible(tmp_path):
    """Each package signs the same votes and proposal with its own file;
    the files are byte-equal, and each loads the other's."""
    seed = SEEDS[0]
    paths = {k: str(tmp_path / f"{k}.json") for k in ("port", "jax")}
    pv = PrivValidator(PrivKey(seed), paths["port"])
    jpv = JPrivValidator(JPrivKey(seed), paths["jax"])
    pv.save()
    jpv.save()
    steps = [_vote(0, 1, 0, TYPE_PREVOTE, "A"),
             _vote(0, 1, 0, TYPE_PRECOMMIT, "A"),
             _vote(0, 2, 1, TYPE_PREVOTE, "nil")]
    for v in steps:
        assert pv.sign_vote(CHAIN, v) == jpv.sign_vote(CHAIN, _jvote(v))
        assert open(paths["port"], "rb").read() == \
            open(paths["jax"], "rb").read()
    prop = Proposal(3, 0, BLOCKS["A"].parts)
    jprop = JProposal.decode(JReader(prop.encode()))
    assert pv.sign_proposal(CHAIN, prop) == jpv.sign_proposal(CHAIN, jprop)
    assert open(paths["port"], "rb").read() == \
        open(paths["jax"], "rb").read()
    # each package loads the other's file and refuses the same regression
    pv2 = PrivValidator.load(paths["jax"])
    jpv2 = JPrivValidator.load(paths["port"])
    assert (pv2.last_height, pv2.last_round, pv2.last_step,
            pv2.last_signature) == (jpv2.last_height, jpv2.last_round,
                                    jpv2.last_step, jpv2.last_signature)
    old = steps[0]
    assert _outcome(lambda: pv2.sign_vote(CHAIN, old))[:2] == \
        _outcome(lambda: jpv2.sign_vote(CHAIN, _jvote(old)))[:2] == \
        ("err", "DoubleSignError")


def test_batch_sign_bytes_rows_are_one_length():
    """Prevotes, precommits and nil votes assemble to rows of one length,
    so bursts of both types from many nodes merge into one K1 launch."""
    from tendermint_tpu_torch.types import SIGN_BYTES_LEN
    from tendermint_tpu_torch.types.vote import batch_verify_vote_sigs
    seen = []

    class Recorder:
        def verify_grouped(self, set_key, pubs, idx, msgs, sigs, *,
                           producer, klass):
            seen.append((msgs.shape, producer, klass))
            return np.ones(len(idx), bool)

    votes = [_vote(0, 9, 2, TYPE_PREVOTE, "A"),
             _vote(1, 9, 2, TYPE_PRECOMMIT, "nil"),
             _vote(2, 9, 3, TYPE_PREVOTE, "B")]
    assert batch_verify_vote_sigs(CHAIN, VALS, votes, Recorder()).all()
    assert seen == [((3, SIGN_BYTES_LEN), "consensus", "consensus")]
    assert SIGN_BYTES_LEN == 128
