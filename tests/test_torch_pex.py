"""The port's address book, PEX reactor and evidence pool held against the
JAX package's on the same inputs: the same picks, buckets, evictions,
promotions and demotions from one seeded generator, `addrbook.json`
files read both ways, a port PEX reactor and a JAX one exchanging
addresses over a `mem_pair` link, the same flood cap, and the same
verdicts of the evidence pool (`tests/test_evidence.py:34-51`)."""

import random
import threading
import time

import pytest

from tendermint_tpu.crypto import backend as jcb
from tendermint_tpu.p2p import addrbook as jaddrbook
from tendermint_tpu.p2p import pex as jpex
from tendermint_tpu.p2p import switch as jswitch
from tendermint_tpu.p2p.types import NetAddress as JNetAddress
from tendermint_tpu.state import evidence as jevidence
from tendermint_tpu.types.codec import Reader as JReader
from tendermint_tpu.types.vote import (DuplicateVoteEvidence as JEvidence,
                                       Vote as JVote)
from tendermint_tpu.utils.db import MemDB as JMemDB
from tendermint_tpu_torch.p2p import AddrBook, PEXReactor, make_switch
from tendermint_tpu_torch.p2p import addrbook, pex, transport
from tendermint_tpu_torch.p2p.types import NetAddress
from tendermint_tpu_torch.scenarios.fixtures import make_validators
from tendermint_tpu_torch.state.evidence import (EvidencePool,
                                                 decode_evidence,
                                                 encode_evidence)
from tendermint_tpu_torch.types import (BlockID, PartSetHeader,
                                        TYPE_PREVOTE)
from tendermint_tpu_torch.types.vote import DuplicateVoteEvidence, Vote
from tendermint_tpu_torch.utils.db import MemDB

from torch_chains import jax_vals

CHAIN = "pex-chain"
DEADLINE_S = 10.0


def _wait(cond, deadline_s: float = DEADLINE_S) -> bool:
    t0 = time.monotonic()
    while time.monotonic() - t0 < deadline_s:
        if cond():
            return True
        time.sleep(0.01)
    return cond()


def _books(seed: int, path="", jpath="", our=None):
    mine = AddrBook(path, our_addrs=our, rng=random.Random(seed))
    theirs = jaddrbook.AddrBook(jpath, our_addrs=our)
    theirs._rng = random.Random(seed)
    return mine, theirs


def _state(book) -> list:
    return sorted((k, e.bucket, e.old, e.attempts, e.src)
                  for k, e in book._entries.items())


def _addr(i: int, rng: random.Random) -> str:
    return (f"tcp://10.{rng.randrange(3)}.{rng.randrange(4)}."
            f"{i % 250 + 1}:{26656 + rng.randrange(3)}")


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_addrbook_script_matches_jax(seed):
    """A seeded script of adds (three buckets' worth from two sources, so
    new buckets fill and evict), failed attempts, promotions past a full
    old bucket, removals, picks and samples: both books in the same state
    after every step, every pick and sample the same."""
    mine, theirs = _books(seed)
    rng = random.Random(100 + seed)
    added = []
    for i in range(3 * addrbook.BUCKET_SIZE):
        s = _addr(i, rng)
        src = f"10.99.0.{rng.randrange(1, 3)}:26656"
        assert (mine.add_address(NetAddress.parse(s), src) ==
                theirs.add_address(JNetAddress.parse(s), src))
        added.append(s)
        op = rng.random()
        pick = rng.choice(added)
        if op < 0.2:
            for _ in range(addrbook.MAX_FAILURES):
                mine.mark_attempt(NetAddress.parse(pick))
                theirs.mark_attempt(JNetAddress.parse(pick))
        elif op < 0.6:
            mine.mark_good(NetAddress.parse(pick))
            theirs.mark_good(JNetAddress.parse(pick))
        elif op < 0.65:
            mine.mark_bad(NetAddress.parse(pick))
            theirs.mark_bad(JNetAddress.parse(pick))
        assert _state(mine) == _state(theirs)
        a, b = mine.pick_address(), theirs.pick_address()
        assert str(a) == str(b)
    assert ([str(a) for a in mine.sample(10)] ==
            [str(a) for a in theirs.sample(10)])
    assert any(e.old for e in mine._entries.values())
    assert mine.size() == theirs.size() <= 3 * addrbook.BUCKET_SIZE


def test_addrbook_bucket_functions_and_own_address():
    rng = random.Random(7)
    for i in range(200):
        key = _addr(i, rng)[6:]
        src = f"10.{rng.randrange(9)}.0.1:26656"
        assert (AddrBook._new_bucket_of(key, src) ==
                jaddrbook.AddrBook._new_bucket_of(key, src))
        assert (AddrBook._old_bucket_of(key) ==
                jaddrbook.AddrBook._old_bucket_of(key))
    # a testnet node listens on 0.0.0.0 and knows itself under that name
    mine, theirs = _books(0, our={"0.0.0.0:26656"})
    own = "tcp://0.0.0.0:26656"
    assert not mine.add_address(NetAddress.parse(own), "x")
    assert not theirs.add_address(JNetAddress.parse(own), "x")
    assert mine.add_address(NetAddress.parse("tcp://0.0.0.0:26658"), "x")


def test_addrbook_json_round_trips_with_jax(tmp_path):
    """A port book's file loads into a JAX book and the other way round,
    with the same entries, buckets, flags and attempt counts."""
    rng = random.Random(42)
    mine, theirs = _books(5, str(tmp_path / "port.json"),
                          str(tmp_path / "jax.json"))
    for i in range(150):
        s = _addr(i, rng)
        src = f"10.99.0.{rng.randrange(1, 5)}:26656"
        mine.add_address(NetAddress.parse(s), src)
        theirs.add_address(JNetAddress.parse(s), src)
        if rng.random() < 0.3:
            mine.mark_attempt(NetAddress.parse(s))
            theirs.mark_attempt(JNetAddress.parse(s))
        if rng.random() < 0.4:
            mine.mark_good(NetAddress.parse(s))
            theirs.mark_good(JNetAddress.parse(s))
    mine.save()
    theirs.save()
    from_port = jaddrbook.AddrBook(str(tmp_path / "port.json"))
    from_jax = AddrBook(str(tmp_path / "jax.json"), rng=random.Random(0))
    assert _state(from_port) == _state(mine) == _state(from_jax)
    for k, e in mine._entries.items():
        assert (e.last_attempt, e.last_success) == (
            from_port._entries[k].last_attempt,
            from_port._entries[k].last_success)


class _Flood:
    """A peer stand-in that counts what the reactor sends back."""

    def __init__(self, pid="flooder"):
        self.id = pid
        self.sent = []

    def try_send(self, ch, msg):
        self.sent.append(msg)
        return True


class _Switch:
    def __init__(self):
        self.stopped = []

    def stop_peer_for_error(self, peer, reason):
        self.stopped.append(reason)


@pytest.mark.parametrize("mod", ["port", "jax"])
def test_pex_flood_cap(mod):
    """Both reactors answer 20 requests a second from one peer and drop
    it on the 21st (MAX_MSGS_PER_SEC x 10 in a 1 s window)."""
    assert pex.MAX_MSGS_PER_SEC == jpex.MAX_MSGS_PER_SEC
    if mod == "port":
        r = PEXReactor(AddrBook(rng=random.Random(0)), ensure_interval=3600)
    else:
        r = jpex.PEXReactor(jaddrbook.AddrBook(), ensure_interval=3600)
    r.set_switch(_Switch())
    peer = _Flood()
    for _ in range(int(pex.MAX_MSGS_PER_SEC * 10)):
        r.receive(pex.PEX_CHANNEL, peer, b'{"type": "request"}')
    assert len(peer.sent) == 20 and not r.switch.stopped
    r.receive(pex.PEX_CHANNEL, peer, b'{"type": "request"}')
    assert r.switch.stopped == ["pex flood"]


def _link(sw, jsw):
    """A port switch dialing a JAX one over an in-memory pair."""
    a, b = transport.mem_pair()
    out, errs = {}, {}

    def run(s, c, k, outbound):
        try:
            out[k] = s.add_peer_from_conn(c, outbound=outbound)
        except Exception as e:
            errs[k] = e
    ts = [threading.Thread(target=run, args=(sw, a, "port", True)),
          threading.Thread(target=run, args=(jsw, b, "jax", False))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(DEADLINE_S)
    assert not errs and set(out) == {"port", "jax"}
    return out


def test_port_pex_and_jax_pex_exchange_addresses():
    """The JAX reactor (inbound side) asks the port's for addresses as a
    peer connects, and the port's asks back: each book learns the other's
    five addresses."""
    book = AddrBook(rng=random.Random(1))
    jbook = jaddrbook.AddrBook()
    for i in range(5):
        book.add_address(NetAddress.parse(f"tcp://10.1.0.{i + 1}:26656"))
        jbook.add_address(JNetAddress.parse(f"tcp://10.2.0.{i + 1}:26656"))
    mine = PEXReactor(book, ensure_interval=3600)
    theirs = jpex.PEXReactor(jbook, ensure_interval=3600)
    sw = make_switch(CHAIN, {"pex": mine}, moniker="port")
    jsw = jswitch.make_switch(CHAIN, {"pex": theirs}, moniker="jax")
    sw.start()
    jsw.start()
    try:
        out = _link(sw, jsw)
        assert _wait(lambda: jbook.size() >= 10)
        mine._request_addrs(out["port"])
        assert _wait(lambda: book.size() >= 10)
        assert {str(a) for a in book.sample(20)} >= {
            f"tcp://10.2.0.{i + 1}:26656" for i in range(5)}
    finally:
        sw.stop()
        jsw.stop()


def test_pex_ensure_fault_is_kept_and_raised_on_stop():
    """An error out of the ensure-peers loop ends it and `stop()` raises
    it (the JAX loop logs it and carries on)."""
    r = PEXReactor(AddrBook(rng=random.Random(0)), ensure_interval=0.01)

    class Broken:
        def peers(self):
            raise RuntimeError("switch broke")
    r.set_switch(Broken())
    r.start()
    assert _wait(lambda: r.fault is not None)
    with pytest.raises(RuntimeError, match="switch broke"):
        r.stop()


# -- the evidence pool -------------------------------------------------------

@pytest.fixture
def _jax_python_backend():
    old = jcb._current
    jcb.set_backend("python")
    yield
    jcb._current = old


def _vote(priv, vs, h, block_hash, chain=CHAIN):
    bid = BlockID(block_hash, PartSetHeader(1, b"\x01" * 32))
    v = Vote(validator_address=priv.address,
             validator_index=vs.index_of(priv.address), height=h, round=0,
             type=TYPE_PREVOTE, block_id=bid)
    return Vote(**{**v.__dict__,
                   "signature": priv.priv_key.sign(v.sign_bytes(chain))})


def _jax_ev(ev):
    return JEvidence(JVote.decode(JReader(ev.vote_a.encode())),
                     JVote.decode(JReader(ev.vote_b.encode())))


def test_evidence_add_dedupe_persist_match_jax(_jax_python_backend):
    privs, vs = make_validators(4)
    jvs = jax_vals(vs)
    db, jdb = MemDB(), JMemDB()
    pool, jpool = EvidencePool(db, CHAIN), jevidence.EvidencePool(jdb, CHAIN)
    ev = DuplicateVoteEvidence(_vote(privs[0], vs, 5, b"\xaa" * 32),
                               _vote(privs[0], vs, 5, b"\xbb" * 32))
    assert pool.add(ev, vs) and jpool.add(_jax_ev(ev), jvs)
    assert not pool.add(ev, vs) and not jpool.add(_jax_ev(ev), jvs)
    assert encode_evidence(ev) == jevidence.encode_evidence(_jax_ev(ev))
    assert decode_evidence(encode_evidence(ev)).vote_a == ev.vote_a
    assert list(db.iterate_prefix(b"ev/")) == list(
        jdb.iterate_prefix(b"ev/"))
    again = EvidencePool(db, CHAIN)
    assert again.size() == 1
    assert again.pending()[0].vote_b.block_id.hash == b"\xbb" * 32


def test_evidence_rejects_fabricated_as_jax_does(_jax_python_backend):
    privs, vs = make_validators(4)
    other, ovs = make_validators(4, seed=9)
    jvs = jax_vals(vs)
    pool, jpool = (EvidencePool(MemDB(), CHAIN),
                   jevidence.EvidencePool(JMemDB(), CHAIN))
    va = _vote(privs[1], vs, 3, b"\xaa" * 32)
    vb = _vote(privs[1], vs, 3, b"\xbb" * 32)
    cases = [
        DuplicateVoteEvidence(_vote(other[0], ovs, 3, b"\xaa" * 32),
                              _vote(other[0], ovs, 3, b"\xbb" * 32)),
        DuplicateVoteEvidence(va, Vote(**{**vb.__dict__,
                                          "signature": b"\x00" * 64})),
        DuplicateVoteEvidence(va, va),
        DuplicateVoteEvidence(va, _vote(privs[1], vs, 4, b"\xbb" * 32)),
    ]
    for ev in cases:
        assert not pool.add(ev, vs)
        assert not jpool.add(_jax_ev(ev), jvs)
    assert pool.size() == jpool.size() == 0


def test_pex_first_round_at_a_random_phase():
    """The ensure-peers loop's first wait is a point of its interval drawn
    from the book's generator, then one interval a round (ROADMAP C.5);
    the JAX loop waits one whole interval first."""
    waits = []

    class Clock:
        def wait(self, t):
            waits.append(t)
            return len(waits) > 2

        def set(self):
            pass
    r = PEXReactor(AddrBook(rng=random.Random(3)), ensure_interval=30.0)
    r._stopped = Clock()
    r.set_switch(_Switch())
    r._ensure_peers = lambda: None
    r._ensure_peers_routine()
    assert waits == [random.Random(3).uniform(0.0, 30.0), 30.0, 30.0]
    assert 0.0 <= waits[0] < 30.0 and r.fault is None
