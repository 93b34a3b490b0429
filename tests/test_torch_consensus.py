"""The port's consensus state machine held against the JAX package's, step
by step under the mock ticker: the same inputs in the same order give the
same round steps, events, own votes, broadcasts, blocks, stored rows and
app hashes (solo validator, no progress without quorum, locking on a POL
and unlocking on a nil polka, the proposal events, the vote micro-batch
ingest).  Also the port's own rules: the micro-batch threshold (scalar
off a card, scalar before two grouped calls) and no fallback (a plane
whose backend raises ends the receive routine, `stop()` raises and no
vote is counted).  Block times come from a patched clock."""

import queue
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from tendermint_tpu.blockchain.store import BlockStore as JBlockStore
from tendermint_tpu.config import test_config as jfast_config
from tendermint_tpu.consensus import messages as JM
from tendermint_tpu.consensus import state as jstate_mod
from tendermint_tpu.consensus.state import ConsensusState as JConsensusState
from tendermint_tpu.consensus.ticker import MockTicker as JMockTicker
from tendermint_tpu.crypto import backend as jcb
from tendermint_tpu.mempool.mempool import Mempool as JMempool
from tendermint_tpu.proxy import ClientCreator as JClientCreator
from tendermint_tpu.state.state import get_state as jget_state
from tendermint_tpu.state.txindex import KVTxIndexer as JKVTxIndexer
from tendermint_tpu.types import PrivKey as JPrivKey
from tendermint_tpu.types.codec import Reader as JReader
from tendermint_tpu.types.priv_validator import PrivValidator as JPrivValidator
from tendermint_tpu.types.vote import Vote as JVote
from tendermint_tpu.utils.db import MemDB as JMemDB
from tendermint_tpu_torch.batchplane import BatchPlane
from tendermint_tpu_torch.blockchain.store import BlockStore
from tendermint_tpu_torch.config import test_config as fast_config
from tendermint_tpu_torch.consensus import messages as M
from tendermint_tpu_torch.consensus import state as state_mod
from tendermint_tpu_torch.consensus.state import ConsensusState, PlaneFault
from tendermint_tpu_torch.consensus.ticker import MockTicker
from tendermint_tpu_torch.crypto import pure_ed25519 as ref
from tendermint_tpu_torch.crypto.backend import CudaBackend, PythonBackend
from tendermint_tpu_torch.mempool.mempool import Mempool
from tendermint_tpu_torch.proxy import ClientCreator
from tendermint_tpu_torch.state.state import get_state
from tendermint_tpu_torch.state.txindex import KVTxIndexer
from tendermint_tpu_torch.types import (BlockID, GenesisDoc, GenesisValidator,
                                        PrivKey, TYPE_PRECOMMIT, TYPE_PREVOTE,
                                        Vote, ZERO_BLOCK_ID)
from tendermint_tpu_torch.types import events as ev
from tendermint_tpu_torch.types.priv_validator import PrivValidator
from tendermint_tpu_torch.utils.db import MemDB

from torch_chains import jax_genesis, share_cores

CHAIN = "cons-chain"
EVENTS = (ev.NEW_ROUND, ev.COMPLETE_PROPOSAL, ev.POLKA, ev.LOCK, ev.UNLOCK,
          ev.RELOCK, ev.TIMEOUT_PROPOSE, ev.TIMEOUT_WAIT)


@pytest.fixture(autouse=True)
def _jax_python_backend():
    old = jcb._current
    jcb.set_backend("python")
    yield
    jcb._current = old


def _seeds(n: int) -> list:
    return [bytes([5, i + 1]) + bytes(30) for i in range(n)]


def _genesis(seeds) -> GenesisDoc:
    return GenesisDoc(chain_id=CHAIN, validators=[
        GenesisValidator(ref.pubkey_from_seed(s), 10) for s in seeds],
        genesis_time_ns=1_000_000_000)


class _Clock:
    """The `time` module with a deterministic `time_ns` (block times)."""

    def __init__(self):
        self.ns = 1_700_000_000_000_000_000

    def time_ns(self):
        self.ns += 1_000_000
        return self.ns

    def __getattr__(self, name):
        return getattr(time, name)


class _Side:
    """One package's state machine with its recorder: events, broadcasts
    and the store, all as comparable data."""

    def __init__(self, pkg: str, seed, gen, monkeypatch, plane=None,
                 app="kvstore", **cfg_kw):
        cfg = (fast_config() if pkg == "port" else jfast_config()).consensus
        cfg.skip_timeout_commit = False     # one height per ticker fire
        for k, v in cfg_kw.items():
            setattr(cfg, k, v)
        self.pkg = pkg
        if pkg == "port":
            monkeypatch.setattr(state_mod, "time", _Clock())
            conns = ClientCreator(app).new_app_conns()
            self.plane = plane or BatchPlane(PythonBackend())
            priv = PrivValidator(PrivKey(seed)) if seed else None
            self.db, self.tx_db = MemDB(), MemDB()
            self.cs = ConsensusState(
                cfg, get_state(MemDB(), gen), conns.consensus,
                BlockStore(self.db), Mempool(conns.mempool, plane=self.plane),
                self.plane, priv_validator=priv,
                tx_indexer=KVTxIndexer(self.tx_db))
            self.ticker = MockTicker(self.cs._on_timeout_fire)
            self.vote_msg, self.encode = M.VoteMessage, M.encode_msg
        else:
            monkeypatch.setattr(jstate_mod, "time", _Clock())
            conns = JClientCreator(app).new_app_conns()
            self.plane = None
            priv = JPrivValidator(JPrivKey(seed)) if seed else None
            self.db, self.tx_db = JMemDB(), JMemDB()
            self.cs = JConsensusState(
                cfg, jget_state(JMemDB(), jax_genesis(gen)),
                conns.consensus, JBlockStore(self.db),
                JMempool(conns.mempool), priv_validator=priv,
                tx_indexer=JKVTxIndexer(self.tx_db))
            self.ticker = JMockTicker(self.cs._on_timeout_fire)
            self.vote_msg, self.encode = JM.VoteMessage, JM.encode_msg
        self.cs._ticker = self.ticker
        self.log = []
        evsw = self.cs.evsw
        for name in EVENTS + (ev.NEW_ROUND_STEP,):
            evsw.subscribe("t", name, lambda rs, name=name: self.log.append(
                (name, rs.height, rs.round, rs.step)))
        evsw.subscribe("t", ev.VOTE, lambda v: self.log.append(
            ("vote", v.encode())))
        evsw.subscribe("t", ev.NEW_BLOCK, lambda b: self.log.append(
            ("block", b.encode())))
        evsw.subscribe("t", "EvidenceDoubleSign", lambda e: self.log.append(
            ("evidence", e.vote_a.encode(), e.vote_b.encode())))
        # broadcasts, but NewRoundStep's elapsed seconds (a wall clock) and
        # the heartbeats a holding proposer's thread signs on its own clock
        self.cs.broadcast_cb = lambda m: None if type(m).__name__ == \
            "ProposalHeartbeatMessage" else self.log.append(
                ("bcast", type(m).__name__,
                 b"" if type(m).__name__ == "NewRoundStepMessage"
                 else self.encode(m)))

    def stop(self):
        self.cs._stopped.set()          # ends a heartbeat thread
        if self.plane is not None:
            self.plane.stop()

    def drain(self) -> None:
        """Handle every queued input as the receive loop would, one
        dispatch at a time."""
        while True:
            try:
                item = self.cs._queue.get_nowait()
            except queue.Empty:
                return
            if isinstance(item, tuple) and isinstance(item[0], self.vote_msg):
                self.cs._handle_vote_run([item])
            else:
                with self.cs._mtx:
                    self.cs._dispatch_one(item)

    def fire(self) -> bool:
        fired = self.ticker.fire_next() is not None
        self.drain()
        return fired

    def feed_votes(self, votes) -> None:
        for v in votes:
            self.cs.add_vote(v if self.pkg == "port" else
                             JVote.decode(JReader(v.encode())), "peer")
        self.drain()

    def summary(self) -> tuple:
        cs = self.cs
        return (cs.height, cs.round, cs.step, cs.locked_round,
                cs.state.app_hash, cs.block_store.height,
                sorted(self.db.iterate_prefix(b"")),
                sorted(self.tx_db.iterate_prefix(b"")))


def _both(seed, gen, monkeypatch, plane=None, **kw):
    return (_Side("port", seed, gen, monkeypatch, plane, **kw),
            _Side("jax", seed, gen, monkeypatch, **kw))


def _signed(seed, vals, height, round_, type_, block_id) -> Vote:
    pub = ref.pubkey_from_seed(seed)
    addr = next(v.address for v in vals.validators
                if v.pub_key.bytes_ == pub)
    v = Vote(addr, vals.index_of(addr), height, round_, type_, block_id)
    return Vote(**{**v.__dict__,
                   "signature": ref.sign(seed, v.sign_bytes(CHAIN))})


def test_solo_validator_step_by_step(monkeypatch):
    seeds = _seeds(1)
    port, jax = _both(seeds[0], _genesis(seeds), monkeypatch)
    try:
        for side in (port, jax):
            side.cs.mempool.check_tx(b"k1=v1")
            side.cs._schedule_round_0()
            for _ in range(3):
                assert side.fire()
        assert port.log == jax.log
        assert port.summary() == jax.summary()
        assert port.cs.block_store.height == 3
        blocks = [x for x in port.log if x[0] == "block"]
        assert len(blocks) == 3
        assert b"k1=v1" in port.cs.block_store.load_block(1).txs
        assert port.summary()[-1]                # the tx was indexed
        # the proposal events, in order, for height 1
        steps = [x[3] for x in port.log if x[0] == ev.NEW_ROUND_STEP
                 and x[1] == 1]
        assert steps[:4] == [state_mod.STEP_PROPOSE, state_mod.STEP_PREVOTE,
                             state_mod.STEP_PRECOMMIT, state_mod.STEP_COMMIT]
        assert (ev.COMPLETE_PROPOSAL, 1, 0, state_mod.STEP_PROPOSE) in \
            port.log
    finally:
        port.stop()
        jax.stop()


def test_wait_for_txs_step_by_step(monkeypatch):
    """`create_empty_blocks = False` (the JAX package's
    `test_wait_for_txs_drains_leftover_pool`): the proof block commits at
    height 1, the proposer then holds in NewRound until the mempool has
    txs, and each later block takes one of the two queued txs."""
    seeds = _seeds(1)
    port, jax = _both(seeds[0], _genesis(seeds), monkeypatch, app="nilapp",
                      create_empty_blocks=False, max_block_size_txs=1)
    try:
        for side in (port, jax):
            side.cs._schedule_round_0()
            assert side.fire()                    # the proof block
            assert side.fire()                    # height 2 holds
            assert side.cs.step == state_mod.STEP_NEW_ROUND
            side.cs.mempool.check_tx(b"t1=a")
            side.cs.mempool.check_tx(b"t2=b")
            side.drain()                          # txs available: propose
            assert side.fire()                    # height 3 from the pool
        assert port.log == jax.log
        assert port.summary() == jax.summary()
        assert [port.cs.block_store.load_block(h).txs
                for h in (1, 2, 3)] == [[], [b"t1=a"], [b"t2=b"]]
    finally:
        port.stop()
        jax.stop()


def test_no_progress_without_quorum(monkeypatch):
    """One of four validators alone: it proposes, times out and prevotes,
    and then waits; nothing commits on either package."""
    seeds = _seeds(4)
    gen = _genesis(seeds)
    proposer = gen.validator_set().proposer.pub_key.bytes_
    for seed in seeds:
        port, jax = _both(seed, gen, monkeypatch)
        try:
            for side in (port, jax):
                side.cs._schedule_round_0()
                for _ in range(6):
                    side.fire()
            assert port.log == jax.log
            assert port.summary() == jax.summary()
            assert port.cs.block_store.height == 0
            assert port.cs.step == state_mod.STEP_PREVOTE
            own = [x for x in port.log if x[0] == "vote"]
            assert len(own) == 1
            proposed = any(x[1] == "ProposalMessage" for x in port.log
                           if x[0] == "bcast")
            assert proposed == (ref.pubkey_from_seed(seed) == proposer)
        finally:
            port.stop()
            jax.stop()


@pytest.mark.parametrize("late", [False, True],
                         ids=["in-round-1", "from-round-0"])
def test_lock_on_polka_then_unlock_on_nil_polka(monkeypatch, late):
    """The proposer of round 0 locks on its block when two peers prevote
    it.  Then either a nil precommit majority moves it to round 1, where
    it prevotes its locked block and a nil polka unlocks it as the votes
    arrive; or, still in round 0, it sees round 1's nil polka and unlocks
    on entering round 1's precommit.  Both packages, event for event."""
    seeds = _seeds(4)
    gen = _genesis(seeds)
    vals = gen.validator_set()
    prop_pub = vals.proposer.pub_key.bytes_
    me = next(s for s in seeds if ref.pubkey_from_seed(s) == prop_pub)
    others = [s for s in seeds if s != me]
    port, jax = _both(me, gen, monkeypatch)
    try:
        for side in (port, jax):
            side.cs._schedule_round_0()
            side.fire()                       # propose B and prevote it
        cs = port.cs
        bid = BlockID(cs.proposal_block.hash(),
                      cs.proposal_block_parts.header)
        polka = [_signed(s, vals, 1, 0, TYPE_PREVOTE, bid)
                 for s in others[:2]]
        nil_r1 = [_signed(s, vals, 1, 1, TYPE_PREVOTE, ZERO_BLOCK_ID)
                  for s in others]
        if late:
            steps = [polka, [_signed(others[0], vals, 1, 0, TYPE_PRECOMMIT,
                                     ZERO_BLOCK_ID)], nil_r1]
        else:
            steps = [polka,
                     [_signed(s, vals, 1, 0, TYPE_PRECOMMIT, ZERO_BLOCK_ID)
                      for s in others],
                     None,                    # the propose timeout fires
                     nil_r1]
        for side in (port, jax):
            for votes in steps:
                if votes is None:
                    assert side.fire()
                else:
                    side.feed_votes(votes)
        assert port.log == jax.log
        assert port.summary() == jax.summary()
        names = [x[0] for x in port.log]
        assert names.index(ev.LOCK) < names.index(ev.UNLOCK)
        own = [Vote.decode(_reader(x[1])) for x in port.log
               if x[0] == "vote"]
        mine = [v for v in own if v.validator_index ==
                vals.index_of(vals.proposer.address)]
        assert [(v.round, v.type, v.is_nil()) for v in mine] == [
            (0, TYPE_PREVOTE, False), (0, TYPE_PRECOMMIT, False)] + (
            [(1, TYPE_PRECOMMIT, True)] if late else
            [(1, TYPE_PREVOTE, False), (1, TYPE_PRECOMMIT, True)])
        assert port.cs.locked_round == -1 and port.cs.round == 1
    finally:
        port.stop()
        jax.stop()


def _reader(b):
    from tendermint_tpu_torch.types.codec import Reader
    return Reader(b)


def test_vote_run_microbatch_ingest(monkeypatch):
    """The JAX package's micro-batch ingest case
    (`tests/test_consensus.py::test_vote_run_microbatch_ingest`): 20
    precommits, one with a bad signature and one equivocation, as one run
    on an observer; the pre-verify forced on (no card here), through the
    port's plane; the same votes land, the same evidence fires."""
    seeds = _seeds(20)
    gen = _genesis(seeds)
    vals = gen.validator_set()
    flushes = []
    plane = BatchPlane(PythonBackend(), on_flush=lambda *a: flushes.append(a))
    port, jax = _both(None, gen, monkeypatch, plane=plane)
    try:
        bid = BlockID(b"\x11" * 32, _psh(1, b"\x22" * 32))
        other = BlockID(b"\x33" * 32, _psh(1, b"\x44" * 32))
        votes = [_signed(s, vals, 1, 0, TYPE_PRECOMMIT, bid) for s in seeds]
        votes[3] = Vote(**{**votes[3].__dict__, "signature": bytes(64)})
        votes.append(_signed(seeds[5], vals, 1, 0, TYPE_PRECOMMIT, other))
        for side in (port, jax):
            side.cs._replay_mode = True
            side.cs._enter_new_round(1, 0)
            side.cs._microbatch_threshold = \
                lambda cs=side.cs: cs.VOTE_MICROBATCH_MIN
            run = [(side.vote_msg(v if side.pkg == "port" else
                                  JVote.decode(JReader(v.encode()))), "p")
                   for v in votes]
            side.cs._handle_vote_run(run)
        assert port.log == jax.log
        pc, jpc = port.cs.votes.precommits(0), jax.cs.votes.precommits(0)
        assert pc.bit_array() == jpc.bit_array()
        assert pc.two_thirds_majority().encode() == \
            jpc.two_thirds_majority().encode()
        bad = vals.index_of(votes[3].validator_address)
        assert pc.bit_array() == [i != bad for i in range(20)]
        assert sum(x[0] == "evidence" for x in port.log) == 1
        # one grouped flush at the consensus class pre-verified the run
        assert [(f[0], f[2], f[3]) for f in flushes] == \
            [("grouped", 21, {"consensus"})]
    finally:
        port.stop()
        jax.stop()


def _psh(total, h):
    from tendermint_tpu_torch.types import PartSetHeader
    return PartSetHeader(total, h)


# -- the micro-batch threshold ---------------------------------------------

def _cs_on(backend):
    seeds = _seeds(1)
    conns = ClientCreator("kvstore").new_app_conns()
    plane = SimpleNamespace(backend=backend)
    return ConsensusState(fast_config().consensus,
                          get_state(MemDB(), _genesis(seeds)),
                          conns.consensus, BlockStore(MemDB()),
                          Mempool(conns.mempool, plane=plane), plane)


def test_threshold_is_scalar_off_a_card():
    off = 1 << 30
    assert _cs_on(PythonBackend())._microbatch_threshold() == off
    be = CudaBackend(device="cpu")
    be.step_count = 5                 # grouped calls change nothing
    assert _cs_on(be)._microbatch_threshold() == off


def test_threshold_waits_for_two_grouped_calls():
    card = SimpleNamespace(name="cuda", device=torch.device("cuda"),
                           step_count=0)
    cs = _cs_on(card)
    for n in (0, 1):
        card.step_count = n
        assert cs._microbatch_threshold() == 1 << 30
    for n in (2, 50):
        card.step_count = n
        assert cs._microbatch_threshold() == cs.VOTE_MICROBATCH_MIN == 16


def test_cuda_backend_counts_its_grouped_calls():
    """`CudaBackend.verify_grouped` counts its synchronous grouped calls
    (here on the plain K1, two keys)."""
    seed = bytes([4, 1]) + bytes(30)
    pubs = np.frombuffer(ref.pubkey_from_seed(seed), np.uint8).reshape(1, 32)
    be = CudaBackend(device="cpu")
    assert be.step_count == 0
    msgs = np.zeros((2, 128), np.uint8)
    sig = ref.sign(seed, bytes(128))
    sigs = np.frombuffer(sig + bytes(64), np.uint8).reshape(2, 64)
    old = share_cores()
    try:
        for _ in range(2):
            assert be.verify_grouped(b"one", pubs, np.zeros(2, np.int32),
                                     msgs, sigs).tolist() == [True, False]
    finally:
        torch.set_num_threads(old)
    assert be.step_count == 2


# -- no fallback -----------------------------------------------------------

def test_plane_fault_stops_the_state_and_counts_no_vote():
    """A burst whose pre-verify fails on the plane: the receive routine
    ends with a `PlaneFault`, `stop()` raises it, and no vote of the run
    is counted on the scalar path in its place."""
    class Broken(PythonBackend):
        def verify_grouped(self, *a):
            raise RuntimeError("K1 launch failed")

    seeds = _seeds(20)
    gen = _genesis(seeds)
    vals = gen.validator_set()
    plane = BatchPlane(Broken())
    conns = ClientCreator("kvstore").new_app_conns()
    cs = ConsensusState(fast_config().consensus, get_state(MemDB(), gen),
                        conns.consensus, BlockStore(MemDB()),
                        Mempool(conns.mempool, plane=plane), plane)
    cs._ticker = MockTicker(cs._on_timeout_fire)
    cs._microbatch_threshold = lambda: cs.VOTE_MICROBATCH_MIN
    bid = BlockID(b"\x11" * 32, _psh(1, b"\x22" * 32))
    try:
        for s in seeds:
            cs.add_vote(_signed(s, vals, 1, 0, TYPE_PREVOTE, bid), "p")
        cs.start()
        cs._thread.join(timeout=60)
        assert not cs._thread.is_alive()
        assert isinstance(cs.fault, PlaneFault)
        assert "K1 launch failed" in str(cs.fault)
        with pytest.raises(PlaneFault):
            cs.stop()
    finally:
        plane.stop()
    assert cs.votes.prevotes(0).sum() == 0
    assert not any(cs.votes.prevotes(0).bit_array())


def test_commit_verify_fault_is_not_a_bad_block():
    """A LastCommit check that fails on the plane is a `PlaneFault`, not
    an invalid block: prevote does not turn it into a nil vote."""
    class Broken(PythonBackend):
        def verify_grouped_templated(self, *a):
            raise ValueError("tmpl_idx out of range")

    verifier = state_mod._CommitVerifier(BatchPlane(Broken()))
    try:
        with pytest.raises(PlaneFault) as e:
            verifier.verify_grouped_templated(
                b"k", np.zeros((1, 32), np.uint8), np.zeros(1, np.int32),
                np.zeros(1, np.int32), np.zeros((1, 128), np.uint8),
                np.zeros((1, 64), np.uint8))
        assert not isinstance(e.value, ValueError)
        assert isinstance(e.value.__cause__, ValueError)
    finally:
        verifier.plane.stop()
