"""The port's reactors held against the JAX package's: the fast-sync wire
messages byte for byte, the block pool's schedule, redo and eviction
sequence under a patched clock, the consensus peer-state model, the
gossip envelopes (each package decodes the other's), and the chain
builder on the plain signer (K3's plain version) against the JAX
fixture.  Then nets: a port syncer fast-syncs from a JAX source over an
in-memory pair and lands where the JAX `test_fast_sync_end_to_end` does;
a lying or pruning peer is blamed on the same heights, in the same order,
as the JAX reactor blames it on the same tampered chain; four port nodes
converge through the reactors alone, a late joiner catches up, and
mempool gossip is height-gated.  Also the port's own rule, no fallback: a
syncer whose grouped verify raises ends its routine and `stop()` raises
it, with no peer blamed or dropped; a raising K5 route makes the mempool
reactor's `receive` raise (any other error of `check_tx` is logged, as in
the JAX package); a gossip routine's error ends it and `stop()` raises
it.  A peer's oversized proposal header drops the peer before any bitmap
is allocated, and its vote bit-arrays take the validator count.  Every wait has its own deadline; no speed is asserted."""

import threading
import time
from types import SimpleNamespace

import pytest

from tendermint_tpu.blockchain import messages as JBM
from tendermint_tpu.blockchain import pool as jpool_mod
from tendermint_tpu.blockchain.reactor import (
    BlockchainReactor as JBlockchainReactor)
from tendermint_tpu.blockchain.store import BlockStore as JBlockStore
from tendermint_tpu.consensus import messages as JM
from tendermint_tpu.consensus.reactor import PeerState as JPeerState
from tendermint_tpu.crypto import backend as jcb
from tendermint_tpu.p2p import make_switch as jmake_switch
from tendermint_tpu.proxy import ClientCreator as JClientCreator
from tendermint_tpu.scenarios import fixtures as jfx
from tendermint_tpu.state import execution as jexecution
from tendermint_tpu.state.state import get_state as jget_state
from tendermint_tpu.types import Block as JBlock
from tendermint_tpu.utils import flowrate as jflowrate
from tendermint_tpu.utils.db import MemDB as JMemDB
from tendermint_tpu_torch.batchplane import BatchPlane
from tendermint_tpu_torch.blockchain import messages as BM
from tendermint_tpu_torch.blockchain import pool as pool_mod
from tendermint_tpu_torch.blockchain.reactor import BlockchainReactor
from tendermint_tpu_torch.blockchain.store import BlockStore
from tendermint_tpu_torch.config import test_config as fast_config
from tendermint_tpu_torch.consensus import messages as M
from tendermint_tpu_torch.consensus import reactor as reactor_mod
from tendermint_tpu_torch.consensus.reactor import (ConsensusReactor,
                                                    PeerState)
from tendermint_tpu_torch.consensus.state import ConsensusState
from tendermint_tpu_torch.crypto.backend import CudaBackend, PythonBackend
from tendermint_tpu_torch.mempool.mempool import Mempool, sign_tx_ed25519
from tendermint_tpu_torch.mempool.reactor import MempoolReactor
from tendermint_tpu_torch.p2p import connect_switches, make_switch, mem_pair
from tendermint_tpu_torch.proxy import ClientCreator
from tendermint_tpu_torch.scenarios import fixtures
from tendermint_tpu_torch.state import execution
from tendermint_tpu_torch.state.state import get_state
from tendermint_tpu_torch.types import Block, Commit, Vote
from tendermint_tpu_torch.utils import flowrate
from tendermint_tpu_torch.utils.db import MemDB

from torch_chains import share_cores

CHAIN = "fastsync-chain"
N_BLOCKS = 24
DEADLINE_S = 90.0


@pytest.fixture(autouse=True)
def _jax_python_backend():
    old = jcb._current
    jcb.set_backend("python")
    yield
    jcb._current = old


@pytest.fixture(scope="module")
def be():
    """One plain-kernel backend per worker: the 4-key set's comb tables
    (the plain K2, a few seconds alone, 40 s and more under a full run's
    load) are built here, once, outside every test's deadline."""
    old = share_cores()
    backend = CudaBackend(device="cpu")
    _, vs = fixtures.make_validators(4)
    backend.tables(vs.set_key(), vs.pubs_matrix())
    yield backend
    import torch
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def chains():
    """The JAX fixture chain and the port's copy of it (same bytes)."""
    privs, vs = jfx.make_validators(4)
    gen = jfx.make_genesis(CHAIN, privs)
    hashes = jfx.kvstore_app_hashes(N_BLOCKS)
    jchain = jfx.build_chain(privs, vs, CHAIN, N_BLOCKS, app_hashes=hashes)
    pprivs, pvs = fixtures.make_validators(4)
    pchain = fixtures.build_chain(pprivs, pvs, CHAIN, N_BLOCKS,
                                  app_hashes=hashes)
    return SimpleNamespace(jchain=jchain, pchain=pchain, hashes=hashes,
                           jgen=gen, gen=fixtures.make_genesis(CHAIN, pprivs))


def _wait(cond, deadline_s: float = DEADLINE_S) -> bool:
    end = time.monotonic() + deadline_s
    while not cond():
        if time.monotonic() > end:
            return False
        time.sleep(0.02)
    return True


# -- wire messages --------------------------------------------------------------

MESSAGES = [("BlockRequest", (7,)), ("BlockResponse", (b"\x01" * 3000,)),
            ("NoBlockResponse", (2 ** 40,)), ("StatusRequest", ()),
            ("StatusResponse", (123,))]


@pytest.mark.parametrize("name,args", MESSAGES, ids=[m[0] for m in MESSAGES])
def test_blockchain_messages_byte_equal(name, args):
    raw = BM.encode_msg(getattr(BM, name)(*args))
    assert raw == JBM.encode_msg(getattr(JBM, name)(*args))
    assert BM.decode_msg(raw).__dict__ == JBM.decode_msg(raw).__dict__


@pytest.mark.parametrize("raw", [b"\x09", b"\x01\x00", b"\x02\x00\x00\x00"])
def test_blockchain_message_decode_errors_match(raw):
    with pytest.raises(Exception) as want:
        JBM.decode_msg(raw)
    with pytest.raises(Exception) as got:
        BM.decode_msg(raw)
    assert type(got.value).__name__ == type(want.value).__name__


# -- block pool under a patched clock -----------------------------------------------

class _Clock:
    def __init__(self):
        self.t = 1000.0

    def monotonic(self):
        return self.t


def _pool_script(pool_module, flow_module, monkeypatch):
    """One scripted run of a BlockPool: peers join, requests go out,
    some are answered, time passes (redos, timeouts, a slow drip), a bad
    block is redone; returns every observable step."""
    clock = _Clock()
    monkeypatch.setattr(pool_module, "time", clock)
    monkeypatch.setattr(flow_module, "time", clock)
    out, evicted = [], []
    pool = pool_module.BlockPool(start_height=1, min_recv_rate=10_240)
    pool.on_evict = lambda p, r: evicted.append((p, r))
    for p, h in (("a", 40), ("b", 40), ("c", 12), ("d", 30)):
        pool.set_peer_height(p, h)
    blk = lambda h: SimpleNamespace(height=h)  # noqa: E731
    for step in range(14):
        reqs = pool.schedule()
        out.append(("schedule", step, reqs))
        for h, p in reqs:
            if p == "d" and step > 2:
                continue                   # d goes silent
            if p == "c" and h % 3:
                continue                   # c drops most of its requests
            out.append(("add", h, p, pool.add_block(p, blk(h))))
            pool.record_bytes(p, 40 if p == "c" else 4096)
        got = pool.peek_contiguous(8)
        out.append(("peek", [b.height for b in got]))
        if step == 5 and got:
            pool.redo(got[-1].height)
        elif got:
            pool.pop(len(got) // 2)
        out.append(("status", {k: v for k, v in pool.status().items()
                               if k != "peer_rates"},
                    pool.is_caught_up(), pool.num_peers(),
                    pool.max_peer_height()))
        clock.t += (0.4, 1.2, 3.5)[step % 3]
    return out, evicted


def test_block_pool_sequence_matches_jax(monkeypatch):
    mine = _pool_script(pool_mod, flowrate, monkeypatch)
    theirs = _pool_script(jpool_mod, jflowrate, monkeypatch)
    assert mine == theirs
    assert mine[1], "the script evicted no peer"


def _queue_script(pool_module, flow_module, monkeypatch, skip=()):
    """One peer serving its requests in order, one block every 0.1 s (a
    rate-limited link: 75 pending ~31 KB blocks at 512,000 B/s take
    ~4.6 s), dropping the first request for each height in `skip`.
    Returns (evictions, the heights popped, the heights redone)."""
    clock = _Clock()
    monkeypatch.setattr(pool_module, "time", clock)
    monkeypatch.setattr(flow_module, "time", clock)
    evicted, popped, sent = [], [], []
    pool = pool_module.BlockPool(start_height=1)
    pool.on_evict = lambda p, r: evicted.append((p, r))
    pool.set_peer_height("a", 150)
    queue = []
    for _ in range(400):
        for h, p in pool.schedule():
            sent.append(h)
            queue.append(h)
        if queue:
            h = queue.pop(0)
            if (h not in skip or sent.count(h) > 1) and pool.add_block(
                    "a", SimpleNamespace(height=h)):
                pool.record_bytes("a", 31_000)
        got = pool.peek_contiguous(64)
        pool.pop(len(got))
        popped += [b.height for b in got]
        clock.t += 0.1
        if pool.next_height > 149 or evicted:
            break
    redone = sorted({h for h in sent if sent.count(h) > 1})
    return evicted, popped, redone


def test_block_pool_keeps_a_peer_working_through_its_queue(monkeypatch):
    """The one rule where the port's pool differs from the JAX pool: a
    request times out after the peer's last delivery, not its sending,
    while the peer has answered no later request.  The JAX pool evicts an
    honest peer whose queue takes longer than REQUEST_TIMEOUT; the port's
    keeps it and gets every block."""
    theirs = _queue_script(jpool_mod, jflowrate, monkeypatch)
    assert theirs[0] == [("a", "request timeouts")]
    evicted, popped, redone = _queue_script(pool_mod, flowrate, monkeypatch)
    assert (evicted, popped[:149], redone) == ([], list(range(1, 150)), [])


def _stall_script(pool_module, flow_module, monkeypatch):
    """One peer whose first ~31 KB block lands 0.5 s after it joined, then
    nothing for a second (its host stalls), then one block every 0.1 s.
    Returns (evictions, the heights popped)."""
    clock = _Clock()
    monkeypatch.setattr(pool_module, "time", clock)
    monkeypatch.setattr(flow_module, "time", clock)
    evicted, popped, queue = [], [], []
    pool = pool_module.BlockPool(start_height=1)
    pool.on_evict = lambda p, r: evicted.append((p, r))
    pool.set_peer_height("a", 40)
    for step in range(120):                # 0.05 s a step
        clock.t = 1000.0 + step * 0.05
        queue += [h for h, _p in pool.schedule()]
        if queue and (step == 10 or (step >= 30 and step % 2 == 0)):
            h = queue.pop(0)
            if pool.add_block("a", SimpleNamespace(height=h)):
                pool.record_bytes("a", 31_000)
        got = pool.peek_contiguous(64)
        pool.pop(len(got))
        popped += [b.height for b in got]
        if evicted:
            break
    return evicted, popped


def test_block_pool_keeps_a_peer_through_a_stall_after_its_first_block(
        monkeypatch):
    """The rate rule reads the peer's rate without the average's bias
    toward its zero start (`Meter.unbiased_rate`).  The JAX pool reads one
    31 KB block and half a second of nothing as under 10 KB/s and evicts
    a peer streaming at ~300 KB/s; the port's keeps it and gets every
    block."""
    theirs = _stall_script(jpool_mod, jflowrate, monkeypatch)
    assert theirs[0] == [("a", "request timeouts")]
    evicted, popped = _stall_script(pool_mod, flowrate, monkeypatch)
    assert (evicted, popped[:40]) == ([], list(range(1, 41)))


def test_flowrate_unbiased_rate_reads_the_mean_of_a_young_meter():
    """A meter that has seen a steady rate for a few windows: `rate()`
    reads a fraction of it (the JAX reading), `unbiased_rate()` the rate
    itself; an old meter reads the same either way."""
    m, jm = flowrate.Meter(now=0.0), jflowrate.Meter(now=0.0)
    for i in range(12):                    # 4,096 B a 0.25 s window
        m.update(4096, now=i * 0.25)
        jm.update(4096, now=i * 0.25)
    assert m.rate(now=3.0) == jm.rate(now=3.0) < 16_384 * 0.75
    assert m.unbiased_rate(now=3.0) == pytest.approx(16_384, rel=1e-9)
    old = flowrate.Meter(now=0.0)
    for i in range(2000):
        old.update(4096, now=i * 0.25)
    assert old.unbiased_rate(now=500.0) == pytest.approx(old.rate(now=500.0),
                                                         rel=1e-9)


def test_block_pool_redoes_a_skipped_request_as_jax_does(monkeypatch):
    """A request its peer skipped (a later one was answered) times out
    REQUEST_TIMEOUT after its sending, as in the JAX pool."""
    evicted, popped, redone = _queue_script(pool_mod, flowrate,
                                            monkeypatch, skip=(5,))
    assert redone == [5] and not evicted
    assert popped[:149] == list(range(1, 150))


# -- consensus peer state and envelopes ---------------------------------------------

def _vote(height, round_, type_, idx, block_hash=b"\x11" * 32):
    from tendermint_tpu_torch.types import BlockID, PartSetHeader
    bid = BlockID(block_hash, PartSetHeader(1, b"\x22" * 32))
    return Vote(validator_address=bytes([idx]) * 20, validator_index=idx,
                height=height, round=round_, type=type_, block_id=bid,
                signature=bytes([idx]) * 64)


def _peer_msgs():
    from tendermint_tpu_torch.types import BlockID, PartSetHeader
    bid = BlockID(b"\x11" * 32, PartSetHeader(1, b"\x22" * 32))
    return [
        M.NewRoundStepMessage(height=5, round=0, step=3,
                              seconds_since_start=1, last_commit_round=0),
        M.HasVoteMessage(height=5, round=0, type=1, index=2),
        M.VoteSetBitsMessage(height=5, round=0, type=2, block_id=bid,
                             votes_bits=(True, False, True, False)),
        M.CommitStepMessage(height=5, parts_total=1, parts_bits=(True,)),
        M.NewRoundStepMessage(height=5, round=1, step=4,
                              seconds_since_start=2, last_commit_round=0),
        M.HasVoteMessage(height=5, round=1, type=2, index=0),
        M.NewRoundStepMessage(height=6, round=0, step=1,
                              seconds_since_start=0, last_commit_round=1),
        M.HasVoteMessage(height=5, round=1, type=2, index=3),
    ]


def _apply(ps, jmod, msg):
    name = type(msg).__name__
    if name == "NewRoundStepMessage":
        ps.apply_new_round_step(msg)
    elif name == "HasVoteMessage":
        ps.set_has_vote(msg.height, msg.round, msg.type, msg.index, 4)
    elif name == "VoteSetBitsMessage":
        if jmod is M:
            ps.apply_vote_set_bits(msg, None, 4)
        else:
            ps.apply_vote_set_bits(msg, None)
    elif name == "CommitStepMessage":
        ps.apply_commit_step(msg)


def test_peer_state_model_matches_jax():
    ps, jps = PeerState(None), JPeerState(None)
    for msg in _peer_msgs():
        _apply(ps, M, msg)
        _apply(jps, JM, JM.decode_msg(M.encode_msg(msg)))
        assert ps.summary() == jps.summary()
    assert ps.pick_missing([True] * 4, [True] * 4) is None


class _Blamer:
    def __init__(self):
        self.stopped = []

    def stop_peer_for_error(self, peer, reason):
        self.stopped.append((peer.id, reason))


def _fed_reactor(n_vals=4):
    """A consensus reactor at height 5 round 0 of `n_vals` validators and
    one peer there, with a switch that records whom it drops."""
    proposals = []
    rs = SimpleNamespace(height=5, round=0, proposal=None,
                         validators=SimpleNamespace(size=lambda: n_vals))
    cs = SimpleNamespace(broadcast_cb=None, get_round_state=lambda: rs,
                         set_proposal=lambda p, pid: proposals.append(p))
    reactor = ConsensusReactor(cs)
    reactor.switch = _Blamer()
    ps = PeerState(None)
    ps.apply_new_round_step(M.NewRoundStepMessage(
        height=5, round=0, step=3, seconds_since_start=0,
        last_commit_round=-1))
    peer = SimpleNamespace(id="p" * 16, get=lambda key: ps)
    return reactor, ps, peer, proposals


@pytest.mark.parametrize("total", [1, reactor_mod.MAX_BLOCK_PARTS,
                                   reactor_mod.MAX_BLOCK_PARTS + 1,
                                   0xFFFFFFFF])
def test_oversized_proposal_header_drops_the_peer(total):
    from tendermint_tpu_torch.types import PartSetHeader
    from tendermint_tpu_torch.types.proposal import Proposal
    reactor, ps, peer, proposals = _fed_reactor()
    prop = Proposal(5, 0, PartSetHeader(total, b"\x22" * 32))
    raw = M.encode_msg(M.StampedMessage(M.ProposalMessage(prop),
                                        sent_ts=0.0, origin=""))
    reactor.receive(reactor_mod.DATA_CHANNEL, peer, raw)
    if total <= reactor_mod.MAX_BLOCK_PARTS:
        assert not reactor.switch.stopped and proposals == [prop]
        assert ps.prs.proposal_block_parts == [False] * total
    else:
        assert reactor.switch.stopped == [(peer.id,
                                           f"proposal of {total} parts")]
        assert not proposals and not ps.prs.proposal
        assert ps.prs.proposal_block_parts is None
    assert reactor.fault is None


def test_vote_set_bits_sized_by_the_validator_set():
    from tendermint_tpu_torch.types import BlockID, PartSetHeader
    reactor, ps, peer, _ = _fed_reactor(n_vals=4)
    bid = BlockID(b"\x11" * 32, PartSetHeader(1, b"\x22" * 32))
    raw = M.encode_msg(M.VoteSetBitsMessage(
        height=5, round=0, type=1, block_id=bid, votes_bits=(True,) * 4096))
    reactor.receive(reactor_mod.VOTE_SET_BITS_CHANNEL, peer, raw)
    assert ps.prs.prevotes[0] == [True] * 4
    assert not reactor.switch.stopped


def test_gossip_envelopes_cross_decode():
    from tendermint_tpu_torch.utils import tracing
    reactor = ConsensusReactor(SimpleNamespace(broadcast_cb=None,
                                               node_id="node7"))
    vote = _vote(9, 1, 2, 3)
    t0 = tracing.now_epoch()
    raw = reactor._stamp(M.VoteMessage(vote))
    jmsg = JM.decode_msg(raw)
    assert type(jmsg).__name__ == "StampedMessage"
    assert t0 <= jmsg.sent_ts <= tracing.now_epoch()
    assert jmsg.origin == "node7"
    assert JM.encode_msg(jmsg.msg) == M.encode_msg(M.VoteMessage(vote))
    assert raw == JM.encode_msg(JM.StampedMessage(
        JM.decode_msg(M.encode_msg(M.VoteMessage(vote))),
        sent_ts=jmsg.sent_ts, origin="node7"))
    # a JAX envelope with a send time and an origin decodes in the port
    jraw = JM.encode_msg(JM.StampedMessage(jmsg.msg, sent_ts=1.5e9,
                                           origin="abcd"))
    msg = M.decode_msg(jraw)
    assert (msg.sent_ts, msg.origin) == (1.5e9, "abcd")
    assert M.encode_msg(msg.msg) == M.encode_msg(M.VoteMessage(vote))


# -- the chain builder ----------------------------------------------------------

def test_fixture_chain_on_the_plain_signer_matches_jax(be, chains):
    privs, vs = fixtures.make_validators(4)
    n = 3
    mine = fixtures.build_chain(privs, vs, CHAIN, n,
                                app_hashes=chains.hashes, backend=be)
    for (b, ps, seen), (jb, jps, jseen) in zip(mine, chains.jchain[:n]):
        assert b.encode() == jb.encode()
        assert ps.header.encode() == jps.header.encode()
        assert seen.encode() == jseen.encode()
    assert [x[0].encode() for x in chains.pchain] == \
        [x[0].encode() for x in chains.jchain]


# -- nets ------------------------------------------------------------------------

def _jax_source(chain, gen):
    state = jget_state(JMemDB(), gen)
    conns = JClientCreator("kvstore").new_app_conns()
    store = JBlockStore(JMemDB())
    for block, ps, seen in chain:
        store.save_block(block, ps, seen)
        jexecution.apply_block(state, None, conns.consensus, block,
                               ps.header, jexecution.MockMempool(),
                               check_last_commit=False)
    reactor = JBlockchainReactor(state, conns.consensus, store,
                                 fast_sync=False)
    return jmake_switch(CHAIN, {"blockchain": reactor}, moniker="source"), \
        store


def _port_source(chain, gen, backend):
    state = get_state(MemDB(), gen)
    conns = ClientCreator("kvstore").new_app_conns()
    store = BlockStore(MemDB())
    for block, ps, seen in chain:
        store.save_block(block, ps, seen)
        execution.apply_block(state, conns.consensus, block, ps.header,
                              execution.MockMempool())
    reactor = BlockchainReactor(state, conns.consensus, store,
                                fast_sync=False, backend=backend)
    return make_switch(CHAIN, {"blockchain": reactor}, moniker="source"), \
        store


def _port_syncer(gen, backend, batch_size=8):
    plane = BatchPlane(backend)
    state = get_state(MemDB(), gen)
    conns = ClientCreator("kvstore").new_app_conns()
    store = BlockStore(MemDB())
    mp = Mempool(conns.mempool, plane=plane)
    cs = ConsensusState(fast_config().consensus, state.copy(),
                        conns.consensus, store, mp, plane)
    cons = ConsensusReactor(cs, fast_sync=True)
    bc = BlockchainReactor(state, conns.consensus, store, fast_sync=True,
                           batch_size=batch_size, backend=backend)
    bc.on_caught_up = cons.switch_to_consensus
    sw = make_switch(CHAIN, {"blockchain": bc, "consensus": cons},
                     moniker="syncer")
    return SimpleNamespace(sw=sw, bc=bc, cons=cons, store=store,
                           plane=plane)


def _connect(a, b):
    """Handshake two switches of either package over an in-memory pair."""
    c1, c2 = mem_pair()
    out, errs = {}, {}

    def run(sw, c, k, outbound):
        try:
            out[k] = sw.add_peer_from_conn(c, outbound=outbound)
        except Exception as e:
            errs[k] = e

    ts = [threading.Thread(target=run, args=(a, c1, 1, True)),
          threading.Thread(target=run, args=(b, c2, 2, False))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(20)
    assert not errs and len(out) == 2, errs
    return out[1], out[2]


def test_port_syncer_fast_syncs_from_a_jax_source(be, chains):
    src, src_store = _jax_source(chains.jchain, chains.jgen)
    y = _port_syncer(chains.gen, be)
    src.start()
    y.sw.start()
    try:
        _connect(y.sw, src)
        # the state, not the store: a block is stored before it is
        # applied (the crash-recovery discipline)
        assert _wait(lambda: y.bc.state.last_block_height >= N_BLOCKS - 1), \
            (f"synced only to {y.store.height} (state "
             f"{y.bc.state.last_block_height}, fault {y.bc.fault!r}): "
             f"{y.bc.pool.status()}")
        for h in range(1, N_BLOCKS - 1):
            assert y.store.load_block(h).encode() == \
                src_store.load_block(h).encode()
        assert y.bc.state.last_block_height >= N_BLOCKS - 1
        assert y.bc.state.app_hash == chains.hashes[N_BLOCKS - 1]
        assert _wait(lambda: not y.cons.fast_sync, 10)
        assert y.bc._switched
        assert y.cons.cs.height == y.bc.state.last_block_height + 1
        assert y.bc.fault is None
    finally:
        y.sw.stop()
        src.stop()
        y.plane.stop()


# -- blame: the same heights and order as the JAX reactor -------------------------

def _tamper(kind, block_bytes, height, decode, block_cls, commit_cls,
            vote_cls):
    """The liar's copy of the block at `height` (encoded), or None when it
    serves this one honestly."""
    if kind == "tx" and height >= 3:
        evil = bytearray(block_bytes)
        evil[-1] ^= 0xFF                   # a tx byte (JAX fastsync test)
        return bytes(evil)
    if kind == "sig" and height >= 5:
        b = decode(block_bytes)
        lc = b.last_commit
        v = lc.precommits[1]
        sig = bytearray(v.signature)
        sig[7] ^= 0x04
        pre = list(lc.precommits)
        pre[1] = vote_cls(**{**v.__dict__, "signature": bytes(sig)})
        return block_cls(header=b.header, txs=b.txs, last_commit=commit_cls(
            block_id=lc.block_id, precommits=pre)).encode()
    if kind == "pruned" and height > 1:
        b = decode(block_bytes)              # JAX test at :378: 1/4 power
        lc = b.last_commit
        keep = [v if i == 0 else None for i, v in enumerate(lc.precommits)]
        return block_cls(header=b.header, txs=b.txs, last_commit=commit_cls(
            block_id=lc.block_id, precommits=keep)).encode()
    return None


def _drive(reactor, raw_blocks, kind, decode, classes, max_steps=60):
    """Feed the reactor's pool by hand, deterministically: two peers, the
    liar first; each answers every request at once (the liar with its
    tampered copies); one `_sync_step` per round.  Returns the redos and
    evictions in order, and how far the state got."""
    pool = reactor.pool
    events = []
    pool.on_evict = lambda p, r: events.append(("evict", p, r))
    redo = pool.redo
    pool.redo = lambda h: (events.append(("redo", h)), redo(h))
    for pid in ("liar", "honest"):
        pool.set_peer_height(pid, len(raw_blocks))
    for _ in range(max_steps):
        for h, pid in pool.schedule():
            raw = raw_blocks[h - 1]
            if pid == "liar":
                raw = _tamper(kind, raw, h, decode, *classes) or raw
            pool.add_block(pid, decode(raw))
        reactor._sync_step()
        if reactor.state.last_block_height >= len(raw_blocks) - 1:
            break
    la = reactor._lookahead
    if la is not None and getattr(la, "thread", None) is not None:
        la.thread.join()
    return events, reactor.state.last_block_height, reactor.state.app_hash


@pytest.mark.parametrize("kind", ["tx", "sig", "pruned"])
def test_lying_peer_blamed_on_the_same_heights_as_jax(be, chains, kind):
    raw = [b.encode() for b, _, _ in chains.jchain]
    jstate = jget_state(JMemDB(), chains.jgen)
    jconns = JClientCreator("kvstore").new_app_conns()
    jr = JBlockchainReactor(jstate, jconns.consensus, JBlockStore(JMemDB()),
                            fast_sync=True, batch_size=4)
    from tendermint_tpu.types import Commit as JCommit, Vote as JVote
    theirs = _drive(jr, raw, kind, JBlock.decode_bytes,
                    (JBlock, JCommit, JVote))
    state = get_state(MemDB(), chains.gen)
    conns = ClientCreator("kvstore").new_app_conns()
    r = BlockchainReactor(state, conns.consensus, BlockStore(MemDB()),
                          fast_sync=True, batch_size=4, backend=be)
    mine = _drive(r, raw, kind, Block.decode_bytes, (Block, Commit, Vote))
    assert mine == theirs
    events, height, app_hash = mine
    assert ("evict", "liar", events[1][2]) in events and \
        not any(e[0] == "evict" and e[1] == "honest" for e in events)
    assert height == N_BLOCKS - 1 and app_hash == chains.hashes[height]
    assert r.fault is None


def test_verify_ahead_windows_consumed_as_in_jax(be, chains):
    """With every block at hand, each window after the first was verified
    ahead (the port: a dispatch on the backend's asynchronous route; the
    JAX package: a thread) and consumed; the same count in both, and the
    same state."""
    raw = [b.encode() for b, _, _ in chains.jchain]
    jstate = jget_state(JMemDB(), chains.jgen)
    jconns = JClientCreator("kvstore").new_app_conns()
    jr = JBlockchainReactor(jstate, jconns.consensus, JBlockStore(JMemDB()),
                            fast_sync=True, batch_size=4)
    from tendermint_tpu.types import Commit as JCommit, Vote as JVote
    theirs = _drive(jr, raw, "none", JBlock.decode_bytes,
                    (JBlock, JCommit, JVote))
    state = get_state(MemDB(), chains.gen)
    conns = ClientCreator("kvstore").new_app_conns()
    store = BlockStore(MemDB())
    r = BlockchainReactor(state, conns.consensus, store, fast_sync=True,
                          batch_size=4, backend=be)
    mine = _drive(r, raw, "none", Block.decode_bytes, (Block, Commit, Vote))
    assert mine == theirs and mine[0] == []
    assert r.lookahead_hits == jr.lookahead_hits >= 1
    assert [w.blocks for w in r.windows] == [4] * 5 + [3]
    for h in range(1, N_BLOCKS):
        assert store.load_block(h).encode() == raw[h - 1]


# -- port nets ------------------------------------------------------------------

class _NetNode:
    def __init__(self, priv, gen, plane, moniker):
        st = get_state(MemDB(), gen)
        self.conns = ClientCreator("kvstore").new_app_conns()
        self.mempool = Mempool(self.conns.mempool, plane=plane)
        self.block_store = BlockStore(MemDB())
        self.cs = ConsensusState(fast_config().consensus, st,
                                 self.conns.consensus, self.block_store,
                                 self.mempool, plane, priv_validator=priv)
        self.cons_reactor = ConsensusReactor(self.cs)
        self.mp_reactor = MempoolReactor(self.mempool)
        self.switch = make_switch(CHAIN, {"consensus": self.cons_reactor,
                                          "mempool": self.mp_reactor},
                                  moniker=moniker)


def _net(n, be):
    privs, _ = fixtures.make_validators(n)
    gen = fixtures.make_genesis(CHAIN, privs)
    plane = BatchPlane(be)
    nodes = [_NetNode(p, gen, plane, f"node{i}")
             for i, p in enumerate(privs)]
    for nd in nodes:
        nd.switch.start()
    return nodes, plane


def _stop(nodes, plane):
    faults = []
    for nd in nodes:
        try:
            nd.switch.stop()
        except Exception as e:
            faults.append(e)
    plane.stop()
    assert not faults, faults


def test_four_port_nodes_converge_through_reactors(be):
    nodes, plane = _net(4, be)
    try:
        for i in range(4):
            for j in range(i + 1, 4):
                connect_switches(nodes[i].switch, nodes[j].switch)
        nodes[0].mempool.check_tx(b"gossip=me")
        assert _wait(lambda: all(nd.block_store.height >= 3
                                 for nd in nodes)), \
            [nd.block_store.height for nd in nodes]
        for h in range(1, 4):
            assert len({nd.block_store.load_block(h).hash()
                        for nd in nodes}) == 1

        def committed():
            bs = nodes[1].block_store
            return [tx for h in range(1, bs.height + 1)
                    for tx in bs.load_block(h).txs]
        assert _wait(lambda: b"gossip=me" in committed(), 30)
    finally:
        _stop(nodes, plane)


def test_late_joiner_catches_up_through_gossip(be):
    nodes, plane = _net(4, be)
    try:
        for i in range(3):
            for j in range(i + 1, 3):
                connect_switches(nodes[i].switch, nodes[j].switch)
        assert _wait(lambda: all(nd.block_store.height >= 3
                                 for nd in nodes[:3]))
        late = nodes[3]
        assert late.block_store.height == 0
        for i in range(3):
            connect_switches(nodes[i].switch, late.switch)
        assert _wait(lambda: late.block_store.height >= 3), \
            late.block_store.height
        for h in range(1, 4):
            assert late.block_store.load_block(h).hash() == \
                nodes[0].block_store.load_block(h).hash()
    finally:
        _stop(nodes, plane)


def test_mempool_gossip_height_gates_a_lagging_peer():
    class FakePRS:
        height = 3

    class FakePS:
        prs = FakePRS()

    plane = BatchPlane(PythonBackend())
    pools, switches = [], []
    for i in range(2):
        conns = ClientCreator("kvstore").new_app_conns()
        mp = Mempool(conns.mempool, plane=plane)
        pools.append(mp)
        switches.append(make_switch(CHAIN, {"mempool": MempoolReactor(mp)},
                                    moniker=f"m{i}"))
    for sw in switches:
        sw.start()
    try:
        p0, _ = connect_switches(switches[0], switches[1])
        p0.set("consensus", FakePS())     # node0's model of the peer
        pools[0]._height = 50
        pools[0].check_tx(b"new=tx")      # admission height 51, peer at 3
        time.sleep(0.5)
        assert b"new=tx" not in pools[1].txs_after(0)
        pools[0]._height = 3
        pools[0].check_tx(b"old=tx")      # admission height 4
        assert _wait(lambda: b"old=tx" in pools[1].txs_after(0), 10)
        FakePRS.height = 51
        switches[0].reactor("mempool")._notify_work()
        assert _wait(lambda: b"new=tx" in pools[1].txs_after(0), 10)
    finally:
        for sw in switches:
            sw.stop()
        plane.stop()


# -- no fallback --------------------------------------------------------------------

class _FailingK1(PythonBackend):
    def verify_grouped_templated(self, *a, **kw):
        raise RuntimeError("K1 launch failed")

    def verify_grouped_templated_async(self, *a, **kw):
        raise RuntimeError("K1 launch failed")


def test_syncer_device_fault_ends_the_sync_blames_no_peer(chains):
    src, _ = _port_source(chains.pchain, chains.gen, PythonBackend())
    y = _port_syncer(chains.gen, _FailingK1())
    src.start()
    y.sw.start()
    try:
        p, _ = _connect(y.sw, src)
        assert _wait(lambda: y.bc.fault is not None, 30)
        assert isinstance(y.bc.fault, RuntimeError)
        time.sleep(0.3)
        assert y.sw.get_peer(p.id) is p and src.n_peers() == 1
        assert y.sw.misbehavior_score(p.id) == 0.0
        assert not y.sw.is_banned(p.id)
        assert y.store.height == 0 and not y.bc._switched
    finally:
        src.stop()
        with pytest.raises(RuntimeError, match="K1 launch failed"):
            y.sw.stop()
        y.plane.stop()


class _FailingK5(PythonBackend):
    def verify_batch(self, *a, **kw):
        raise RuntimeError("K5 launch failed")


def test_mempool_receive_raises_on_a_failing_k5_route():
    plane = BatchPlane(_FailingK5())
    conns = ClientCreator("kvstore").new_app_conns()
    reactor = MempoolReactor(Mempool(conns.mempool, plane=plane))
    tx = sign_tx_ed25519(b"\x05" * 32, b"payload", priority=1)
    try:
        with pytest.raises(RuntimeError, match="K5 launch failed"):
            reactor.receive(0x30, SimpleNamespace(id="peer"), tx)
        assert isinstance(reactor.fault, RuntimeError)
        with pytest.raises(RuntimeError, match="K5 launch failed"):
            reactor.stop()
    finally:
        plane.stop()


def test_mempool_receive_logs_a_check_tx_error_that_is_no_fault():
    def check_tx(tx):
        raise ValueError("app refused the encoding")

    reactor = MempoolReactor(SimpleNamespace(check_tx=check_tx))
    reactor.receive(0x30, SimpleNamespace(id="peer"), b"tx")
    assert reactor.fault is None
    reactor.stop()


def test_mempool_k5_fault_over_the_wire_keeps_the_link():
    planes = [BatchPlane(_FailingK5()), BatchPlane(PythonBackend())]
    switches = []
    for i, plane in enumerate(planes):
        conns = ClientCreator("kvstore").new_app_conns()
        switches.append(make_switch(CHAIN, {"mempool": MempoolReactor(
            Mempool(conns.mempool, plane=plane))}, moniker=f"m{i}"))
    for sw in switches:
        sw.start()
    try:
        _, p1 = connect_switches(switches[0], switches[1])
        p1.send(0x30, sign_tx_ed25519(b"\x06" * 32, b"x", priority=0))
        assert _wait(lambda: switches[0].fault is not None, 10)
        time.sleep(0.2)
        assert switches[0].n_peers() == 1 and switches[1].n_peers() == 1
        assert switches[0].misbehavior_score(p1.id) == 0.0
    finally:
        with pytest.raises(RuntimeError, match="K5 launch failed"):
            switches[0].stop()
        switches[1].stop()
        for plane in planes:
            plane.stop()


def test_gossip_routine_fault_ends_it_and_stop_raises():
    rs = SimpleNamespace(height=1, round=0, step=1, start_time=0.0,
                         last_commit=None)
    def get_round_state():
        if threading.current_thread() is not threading.main_thread():
            raise RuntimeError("round state fault")     # a gossip routine
        return rs

    cs = SimpleNamespace(broadcast_cb=None, get_round_state=get_round_state,
                         stop=lambda: None)
    reactor = ConsensusReactor(cs)
    peer = SimpleNamespace(id="p" * 16, data={}, try_send=lambda *a: True,
                           set=lambda k, v: None)
    reactor.add_peer(peer)
    assert _wait(lambda: reactor.fault is not None, 10)
    with pytest.raises(RuntimeError, match="round state fault"):
        reactor.stop()
