"""The pipelined fast-sync replay (`replay_pipelined`) and the backend's
asynchronous grouped verify, held against the serial `replay` and the
JAX package's `verify_commits_batched` + `apply_window` window loop on
the same chains: heights, app hashes, per-window tallies, the block
store's contents, the same error at the same height and lane for a
forged lane, a pruned commit and a foreign commit, a validator-set
change made by the app (the speculative window is redone, counted, not
timed), a stop mid-window resumed after the handshake, and the
asynchronous K1 route equal to the synchronous one."""

import numpy as np
import pytest

from tendermint_tpu.abci.app import Application as JApplication
from tendermint_tpu.abci.types import (ResponseEndBlock as JResponseEndBlock,
                                       Validator as JAbciValidator)
from tendermint_tpu.crypto import backend as jcb
from tendermint_tpu.proxy import ClientCreator as JClientCreator
from tendermint_tpu.state import execution as jexec
from tendermint_tpu.state.state import get_state as jget_state
from tendermint_tpu.types import BlockID as JBlockID
from tendermint_tpu.types.part_set import from_data_batched as jfrom_data
from tendermint_tpu.types.validator import (
    verify_commits_batched as jverify_commits, window_commit_lanes as jlanes)
from tendermint_tpu.utils.db import MemDB as JMemDB
from tendermint_tpu_torch.abci.app import Application
from tendermint_tpu_torch.abci.types import (ResponseEndBlock,
                                             Validator as AbciValidator)
from tendermint_tpu_torch.blockchain import replay as rp
from tendermint_tpu_torch.blockchain.store import BlockStore
from tendermint_tpu_torch.consensus.replay import Handshaker
from tendermint_tpu_torch.crypto import pure_ed25519 as ref
from tendermint_tpu_torch.crypto.backend import CudaBackend, PythonBackend
from tendermint_tpu_torch.proxy import ClientCreator
from tendermint_tpu_torch.state.state import get_state
from tendermint_tpu_torch.types import (BlockID, CompactCommit, GenesisDoc,
                                        GenesisValidator, ZERO_BLOCK_ID,
                                        canonical)
from tendermint_tpu_torch.types.part_set import PartSetHeader
from tendermint_tpu_torch.types.validator import window_commit_lanes
from tendermint_tpu_torch.utils.db import MemDB, SQLiteDB

from torch_chains import (GoldenSigner, jax_block, jax_commit, jax_genesis,
                          share_cores)

N_VALS, N_BLOCKS, WINDOW = 4, 10, 3
BAD_HEIGHT, BAD_LANE = 8, 2          # in the third window
CHANGE_AT = 4                        # EndBlock here adds a validator
NEW_SEED = b"\x42" * 32


@pytest.fixture(autouse=True, scope="module")
def _share_cores():
    n = share_cores()
    yield
    import torch
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _jax_python_backend():
    old = jcb._current
    jcb.set_backend("python")
    yield
    jcb._current = old


@pytest.fixture(scope="module")
def chain():
    return rp.build_chain(N_VALS, N_BLOCKS, GoldenSigner(), payload=512)


def _conns(app="kvstore"):
    return ClientCreator(app).new_app_conns().consensus


def _jax_replay(genesis, blocks, commits, app="kvstore", window=WINDOW):
    """The JAX package's window loop (its reactor's prepare + verify +
    apply, without the network): windows cut at the first block naming
    another validator set.  Returns (state, per-window tallies)."""
    jstate = jget_state(JMemDB(), jax_genesis(genesis))
    jconns = JClientCreator(app).new_app_conns()
    jblocks = [jax_block(b) for b in blocks]
    jcommits = [jax_commit(c) for c in commits]
    tallies, i = [], 0
    while i < len(jblocks):
        win = jblocks[i:i + window]
        vh = jstate.validators.hash()
        cut = next((k for k, b in enumerate(win)
                    if b.header.validators_hash != vh), len(win))
        win = win[:cut]
        parts = jfrom_data([b.encode() for b in win])
        items = [(JBlockID(b.hash(), ps.header), b.height, c)
                 for b, ps, c in zip(win, parts, jcommits[i:i + cut])]
        tallies.append(jlanes(jstate.validators, jstate.chain_id,
                              items)[5].tolist())
        jverify_commits(jstate.validators, jstate.chain_id, items)
        jexec.apply_window(jstate, None, jconns.consensus,
                           [(b, ps.header) for b, ps in zip(win, parts)],
                           jexec.MockMempool(), save_every=0)
        i += cut
    return jstate, tallies


def _state_key(st) -> tuple:
    return (st.last_block_height, st.app_hash, st.last_block_id.key(),
            st.validators.hash())


@pytest.mark.parametrize("window,depth", [(3, 3), (1, 2), (4, 1)])
def test_pipelined_matches_serial_and_reference(chain, window, depth,
                                                monkeypatch):
    monkeypatch.setattr(rp, "PIPELINE_DEPTH", depth)
    be = PythonBackend()
    st = get_state(MemDB(), chain.genesis)
    serial = rp.replay(st, _conns(), chain.blocks, chain.commits, be,
                       window=window)
    pst = get_state(MemDB(), chain.genesis)
    store = BlockStore(MemDB())
    piped = rp.replay_pipelined(pst, _conns(), chain.blocks, chain.commits,
                                be, window=window, store=store)
    jstate, tallies = _jax_replay(chain.genesis, chain.blocks,
                                  chain.commits, window=window)
    assert _state_key(pst) == _state_key(st)
    assert (pst.last_block_height, pst.app_hash, pst.last_block_id.key()) \
        == (jstate.last_block_height, jstate.app_hash,
            jstate.last_block_id.key())
    assert [w.tallied for w in piped.windows] == \
        [w.tallied for w in serial.windows] == tallies
    assert [(w.first_height, w.blocks, w.lanes) for w in piped.windows] == \
        [(w.first_height, w.blocks, w.lanes) for w in serial.windows]
    assert (piped.height, piped.app_hash, piped.sigs, piped.redone,
            piped.stopped) == (N_BLOCKS, serial.app_hash, serial.sigs, 0,
                               False)
    assert set(piped.busy_s) == {"prepare", "verify", "apply"}
    assert piped.wall_s > 0
    vals = chain.genesis.validator_set()
    assert store.height == N_BLOCKS
    for h in range(1, N_BLOCKS + 1):
        assert store.load_block(h).hash() == chain.blocks[h - 1].hash()
        assert store.load_seen_commit(h).encode() == \
            chain.commits[h - 1].to_commit(vals).encode()
    # without a store the state is saved once per window
    nst = get_state(MemDB(), chain.genesis)
    rp.replay_pipelined(nst, _conns(), chain.blocks, chain.commits, be,
                        window=window)
    assert _state_key(nst) == _state_key(st)


class _Counting(PythonBackend):
    """Counts dispatches and the most calls in flight at once, and logs
    each dispatch and collect with the state's height at that moment."""

    def __init__(self, state=None):
        self.dispatched = self.inflight = self.most = 0
        self.state, self.log = state, []

    def verify_grouped_templated_async(self, *args, **kw):
        collect = super().verify_grouped_templated_async(*args, **kw)
        self.dispatched += 1
        self.inflight += 1
        self.most = max(self.most, self.inflight)
        n = self.dispatched
        if self.state is not None:
            self.log.append(("dispatch", n, self.state.last_block_height))

        def counted():
            self.inflight -= 1
            if self.state is not None:
                self.log.append(("collect", n, self.state.last_block_height))
            return collect()
        return counted


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_depth_of_dispatch(chain, depth, monkeypatch):
    monkeypatch.setattr(rp, "PIPELINE_DEPTH", depth)
    be = _Counting()
    st = get_state(MemDB(), chain.genesis)
    res = rp.replay_pipelined(st, _conns(), chain.blocks, chain.commits, be,
                              window=2)
    assert res.height == N_BLOCKS
    assert (be.dispatched, be.most, be.inflight) == (5, depth, 0)


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_dispatch_runs_ahead_of_apply(chain, depth, monkeypatch):
    """Window k + depth - 1 is dispatched before window k is collected and
    applied: windows of 2 blocks, so window k starts at height 2k - 1."""
    monkeypatch.setattr(rp, "PIPELINE_DEPTH", depth)
    st = get_state(MemDB(), chain.genesis)
    be = _Counting(st)
    rp.replay_pipelined(st, _conns(), chain.blocks, chain.commits, be,
                        window=2)
    want = [("dispatch", j, 0) for j in range(1, depth)]
    for k in range(1, 6):
        if k + depth - 1 <= 5:
            want.append(("dispatch", k + depth - 1, 2 * (k - 1)))
        want.append(("collect", k, 2 * (k - 1)))
    assert be.log == want


def _forged(c):
    sigs = c.sigs.copy()
    sigs[BAD_LANE, 9] ^= 0x04
    return CompactCommit(c.block_id, c.height_, c.round_, sigs, c.present)


def _pruned(c):
    present = c.present.copy()
    present[:2] = False
    return CompactCommit(c.block_id, c.height_, c.round_, c.sigs, present)


def _foreign(c, seeds, chain_id):
    """A commit signed by every validator for ANOTHER block at the same
    height."""
    other = BlockID(b"\x77" * 32, PartSetHeader(1, b"\x66" * 32))
    msg = canonical.sign_bytes(chain_id, canonical.TYPE_PRECOMMIT,
                               c.height_, 0, block_hash=other.hash,
                               parts_hash=other.parts.hash, parts_total=1)
    sigs = np.frombuffer(b"".join(ref.sign(s, msg) for s in seeds),
                         np.uint8).reshape(-1, 64)
    return CompactCommit(other, c.height_, 0, sigs, c.present)


@pytest.mark.parametrize("kind", ["forged", "pruned", "foreign"])
def test_bad_commit_same_error(chain, kind):
    commits = list(chain.commits)
    c = commits[BAD_HEIGHT - 1]
    commits[BAD_HEIGHT - 1] = (
        _forged(c) if kind == "forged" else _pruned(c) if kind == "pruned"
        else _foreign(c, chain.seeds, chain.genesis.chain_id))
    be = PythonBackend()
    errors, heights = [], []
    for run in (rp.replay, rp.replay_pipelined):
        st = get_state(MemDB(), chain.genesis)
        with pytest.raises(ValueError) as e:
            run(st, _conns(), chain.blocks, commits, be, window=WINDOW)
        errors.append(e.value)
        heights.append(st.last_block_height)
    with pytest.raises(ValueError) as want:
        _jax_replay(chain.genesis, chain.blocks, commits)
    got = [(type(e).__name__, str(e), e.height) for e in errors]
    assert got[0] == got[1] == (type(want.value).__name__, str(want.value),
                                BAD_HEIGHT)
    assert {"forged": "CommitSignatureError", "pruned": "CommitPowerError",
            "foreign": "CommitPowerError"}[kind] == got[0][0]
    if kind == "forged":
        assert errors[0].lane == errors[1].lane == want.value.lane \
            == BAD_LANE
    else:
        assert errors[1].foreign_votes == want.value.foreign_votes \
            == (kind == "foreign")
    # the windows before the failing one were applied, not the rest
    assert heights == [6, 6]


# -- a validator-set change made by the app ---------------------------------

class _GrowApp(Application):
    def end_block(self, height):
        return ResponseEndBlock(diffs=[AbciValidator(
            ref.pubkey_from_seed(NEW_SEED), 5)] if height == CHANGE_AT
            else [])


class _JGrowApp(JApplication):
    def end_block(self, height):
        return JResponseEndBlock(diffs=[JAbciValidator(
            ref.pubkey_from_seed(NEW_SEED), 5)] if height == CHANGE_AT
            else [])


def _valset_chain(n_blocks: int, headers_follow: bool):
    """A chain whose app adds a validator at CHANGE_AT.  With
    `headers_follow` the later headers name the grown set and its
    commits are signed by it (a valid chain); without, the headers keep
    naming the old set (the app and the chain disagree)."""
    seeds = [bytes([1, i + 1]) + b"\0" * 30 for i in range(N_VALS)]
    genesis = GenesisDoc(
        chain_id="grow-chain", genesis_time_ns=1_000_000_000,
        validators=[GenesisValidator(ref.pubkey_from_seed(s), 10)
                    for s in seeds])
    old = genesis.validator_set()
    grown = old.copy()
    grown.apply_updates([(ref.pubkey_from_seed(NEW_SEED), 5)])
    by_pub = {ref.pubkey_from_seed(s): s for s in seeds + [NEW_SEED]}
    blocks, commits, last = [], [], ZERO_BLOCK_ID
    for h in range(1, n_blocks + 1):
        vs = grown if headers_follow and h > CHANGE_AT else old
        prev = grown if headers_follow and h - 1 > CHANGE_AT else old
        block, bid = rp.make_block(genesis.chain_id, h, [b"t%d" % h], last,
                                   prev.size(), vs.hash(), b"")
        msg = canonical.sign_bytes(
            genesis.chain_id, canonical.TYPE_PRECOMMIT, h, 0,
            block_hash=bid.hash, parts_hash=bid.parts.hash,
            parts_total=bid.parts.total)
        sigs = np.frombuffer(b"".join(
            ref.sign(by_pub[v.pub_key.bytes_], msg) for v in vs.validators),
            np.uint8).reshape(-1, 64)
        commits.append(CompactCommit(bid, h, 0, sigs,
                                     np.ones(vs.size(), bool)))
        blocks.append(block)
        last = bid
    return genesis, blocks, commits


def test_valset_change_redoes_the_speculative_window():
    genesis, blocks, commits = _valset_chain(8, headers_follow=True)
    be = _Counting()
    st = get_state(MemDB(), genesis)
    serial = rp.replay(st, ClientCreator(_GrowApp()).new_app_conns()
                       .consensus, blocks, commits, PythonBackend(),
                       window=WINDOW)
    pst = get_state(MemDB(), genesis)
    piped = rp.replay_pipelined(pst, ClientCreator(_GrowApp())
                                .new_app_conns().consensus, blocks, commits,
                                be, window=WINDOW)
    jstate, tallies = _jax_replay(genesis, blocks, commits,
                                  app=_JGrowApp())
    assert pst.validators.size() == N_VALS + 1
    assert _state_key(pst) == _state_key(st)
    assert (pst.last_block_height, pst.app_hash, pst.last_block_id.key(),
            pst.validators.hash()) == (
        jstate.last_block_height, jstate.app_hash,
        jstate.last_block_id.key(), jstate.validators.hash())
    # windows [1-3], [4] (cut: block 5 names the grown set), [5-7], [8]
    want = [(1, 3), (4, 1), (5, 3), (8, 1)]
    assert [(w.first_height, w.blocks) for w in piped.windows] == want
    assert [(w.first_height, w.blocks) for w in serial.windows] == want
    assert [w.tallied for w in piped.windows] == tallies
    # the speculative window at 5 (against the old set) was discarded and
    # prepared again against the live set; only live windows dispatched
    assert (piped.redone, be.dispatched) == (1, 4)


def test_app_and_headers_disagree_on_the_set():
    genesis, blocks, commits = _valset_chain(8, headers_follow=False)
    heights = []
    for run in (rp.replay, rp.replay_pipelined):
        st = get_state(MemDB(), genesis)
        be = _Counting()
        with pytest.raises(ValueError, match="validators_hash"):
            run(st, ClientCreator(_GrowApp()).new_app_conns().consensus,
                blocks, commits, be, window=WINDOW)
        heights.append(st.last_block_height)
    # the pipeline stopped the window at the change, discarded window
    # [7-8] verified against the old set, and found block 5 naming it
    assert heights == [CHANGE_AT, CHANGE_AT]
    assert be.dispatched == 3


# -- stop mid-window, restart through the handshake -------------------------

@pytest.mark.parametrize("store_ahead", [False, True])
def test_stop_restart_resume(chain, tmp_path, store_ahead):
    be = PythonBackend()
    full = get_state(MemDB(), chain.genesis)
    rp.replay_pipelined(full, _conns(), chain.blocks, chain.commits, be,
                        window=WINDOW)
    path = str(tmp_path / "node.db")
    db = SQLiteDB(path)
    st, store = get_state(db, chain.genesis), BlockStore(db)
    res = rp.replay_pipelined(st, _conns(), chain.blocks, chain.commits, be,
                              window=WINDOW, store=store,
                              stop_when=lambda: st.last_block_height == 5)
    assert res.stopped and (res.height, store.height) == (5, 5)
    if store_ahead:     # a crash after the store saved block 6
        b = chain.blocks[5]
        store.save_block(b, b.make_part_set(), chain.commits[5],
                         validators=st.validators)
    db.close()

    db = SQLiteDB(path)
    st, store = get_state(db, chain.genesis), BlockStore(db)
    assert st.last_block_height == 5
    conns = ClientCreator("kvstore").new_app_conns()
    hs = Handshaker(st, store)
    app_hash = hs.handshake(conns)
    assert hs.n_blocks == 6 if store_ahead else 5
    assert app_hash == st.app_hash
    h = st.last_block_height
    res = rp.replay_pipelined(st, conns.consensus, chain.blocks[h:],
                              chain.commits[h:], be, window=WINDOW,
                              store=store)
    assert (res.height, store.height) == (N_BLOCKS, N_BLOCKS)
    assert _state_key(st) == _state_key(full)


# -- the asynchronous K1 route (plain versions on the CPU) ------------------

@pytest.fixture(scope="module")
def cuda_cpu(chain):
    """A CPU CudaBackend with the chain's set's tables (plain K2)."""
    be = CudaBackend(device="cpu")
    vals = chain.genesis.validator_set()
    be.tables(vals.set_key(), vals.pubs_matrix())
    return be


def _window_lanes(chain, lo, hi):
    vals = chain.genesis.validator_set()
    _, _, items = rp.prepare_window(chain.blocks[lo:hi], chain.commits[lo:hi],
                                    vals.hash(), None)
    templates, tmpl_idx, sigs, idxs, *_ = window_commit_lanes(
        vals, chain.genesis.chain_id, items)
    return vals, (idxs, tmpl_idx, templates, sigs)


def test_async_route_equals_sync(chain, cuda_cpu):
    be = cuda_cpu
    vals, lanes = _window_lanes(chain, 0, 5)
    key, pubs = vals.set_key(), vals.pubs_matrix()
    idxs, tmpl_idx, templates, sigs = lanes
    sigs = sigs.copy()
    sigs[[3, 11], 40] ^= 0x80                        # two forged lanes
    lanes = (idxs, tmpl_idx, templates, sigs)
    want = be.verify_grouped_templated(key, pubs, *lanes)
    assert want.tolist() == [i not in (3, 11) for i in range(len(idxs))]
    assert np.array_equal(PythonBackend().verify_grouped_templated(
        key, pubs, *lanes), want)
    # 0 lanes
    empty = be.verify_grouped_templated_async(
        key, pubs, idxs[:0], tmpl_idx[:0], templates, sigs[:0])()
    assert empty.dtype == bool and empty.shape == (0,)
    # prefetched and padded inputs with real_n
    pre = be.prefetch_grouped_lanes(*lanes)
    assert pre[4] == len(idxs) and pre[0].shape[0] == 32
    got = be.verify_grouped_templated_async(key, pubs, *pre[:4],
                                            real_n=pre[4])()
    assert np.array_equal(got, want)
    # three in flight on distinct inputs, collected in turn
    batches = [_window_lanes(chain, lo, lo + 2)[1] for lo in (2, 5, 8)]
    collects = [be.verify_grouped_templated_async(key, pubs, *b)
                for b in batches]
    for b, collect in zip(batches, collects):
        assert np.array_equal(collect(),
                              be.verify_grouped_templated(key, pubs, *b))
    with pytest.raises(ValueError, match="tmpl_idx"):
        be.prefetch_grouped_lanes(idxs, tmpl_idx + 9, templates, sigs)


def test_pipelined_on_the_cuda_backend(chain, cuda_cpu):
    st = get_state(MemDB(), chain.genesis)
    ref_st = get_state(MemDB(), chain.genesis)
    rp.replay(ref_st, _conns(), chain.blocks, chain.commits, PythonBackend(),
              window=4)
    res = rp.replay_pipelined(st, _conns(), chain.blocks, chain.commits,
                              cuda_cpu, window=4)
    assert _state_key(st) == _state_key(ref_st)
    assert res.sigs == N_BLOCKS * N_VALS


def test_chain_not_at_the_next_height(chain):
    """Blocks that do not start at the state's next height: the same
    error from both loops, nothing applied."""
    errors = []
    for run in (rp.replay, rp.replay_pipelined):
        st = get_state(MemDB(), chain.genesis)
        with pytest.raises(ValueError) as e:
            run(st, _conns(), chain.blocks[2:], chain.commits[2:],
                PythonBackend(), window=WINDOW)
        errors.append((str(e.value), st.last_block_height))
    assert errors[0] == errors[1] == ("wrong height 3, expected 1", 0)


class _FailingLaunch(PythonBackend):
    """Its third dispatch fails as a kernel launch would."""

    def __init__(self):
        self.calls = 0

    def verify_grouped_templated_async(self, *args, **kw):
        self.calls += 1
        if self.calls == 3:
            raise RuntimeError("verify_grouped: CUDA launch failed, error 1")
        return super().verify_grouped_templated_async(*args, **kw)


def test_launch_failure_propagates(chain):
    """No retry and no fallback: the launch error reaches the caller at
    once, before the two windows in flight are collected or applied."""
    st = get_state(MemDB(), chain.genesis)
    with pytest.raises(RuntimeError, match="launch failed"):
        rp.replay_pipelined(st, _conns(), chain.blocks, chain.commits,
                            _FailingLaunch(), window=2)
    assert st.last_block_height == 0
