"""Fast-sync window replay and its chain fixture.

The replay loops are the window loop of the reference's fast-sync reactor
(`tendermint_tpu/blockchain/reactor.py` `_prepare_window` + `_sync_step`)
and of its benchmark (`bench.py` `_replay_chain`), without networking.
Each window of blocks goes through three steps:

1. prepare — re-hash every block's part set (`from_data_batched`) and pair
   each block's ID with the +2/3 commit that proves it;
2. verify — every commit signature of the window in ONE grouped backend
   call (`verify_commits_batched`, kernel K1 on the "cuda" backend);
3. apply — execute the window through the ABCI app (`apply_window`).

`replay` runs them one after another, window by window: the reference
loop.  `replay_pipelined` dispatches each window's K1 call
asynchronously, up to `PIPELINE_DEPTH` windows ahead of the one it
applies, so the card's verify runs under the host's prepare and apply,
all on one thread; it can save each block to a `BlockStore` before
applying it.

Both record the fast-sync reactor's spans in the flight recorder
(`fastsync.prepare`, `.verify` on the serial loop, `.apply`, and a
`fastsync.window` envelope with the window's first height as its
`window` key, from its prepare to the end of its apply), so the
attribution doctor partitions each window's wall clock; the backend adds
its own (`transfer.h2d`, `verify.dispatch`, `verify.collect`).

`build_chain` makes a deterministic chain in the shape of the reference's
benchmark fixture (`bench.py` `_fixture_build_base`): hash-linked blocks
with one ~12 KB kvstore tx each, and seen commits signed in bulk by the
backend (kernel K3 on the "cuda" backend).
"""

from __future__ import annotations

import gc
import time
from collections import deque
from collections.abc import Callable
from dataclasses import dataclass, field

import numpy as np

from tendermint_tpu_torch.abci.app import create_app
from tendermint_tpu_torch.crypto import pure_ed25519 as ref
from tendermint_tpu_torch.state import execution
from tendermint_tpu_torch.types import (Block, BlockID, Commit,
                                        CompactCommit, EMPTY_COMMIT,
                                        GenesisDoc, GenesisValidator,
                                        ZERO_BLOCK_ID, canonical)
from tendermint_tpu_torch.types.part_set import from_data_batched
from tendermint_tpu_torch.types.validator import (verify_commits_batched,
                                                  window_commit_lanes,
                                                  window_tally_check)
from tendermint_tpu_torch.utils import tracing

DEFAULT_WINDOW = 625          # BASELINE config 3: 62,500 lanes at V = 100
PIPELINE_DEPTH = 3            # K1 calls in flight (`bench.py` _replay_chain)
SIGN_CHUNK_BLOCKS = 655       # 65,500 signing lanes per call at V = 100


@dataclass
class Chain:
    """A replayable chain: genesis, blocks, and each block's seen commit
    (the +2/3 precommits for it, in array form)."""
    genesis: GenesisDoc
    seeds: list[bytes]          # in validator-set order
    blocks: list[Block]
    commits: list[CompactCommit]


@dataclass
class WindowStats:
    first_height: int
    blocks: int
    lanes: int
    tallied: list[int]         # per block: power voting for it
    prepare_s: float
    verify_s: float
    apply_s: float


@dataclass
class ReplayResult:
    height: int
    app_hash: bytes
    windows: list[WindowStats] = field(default_factory=list)

    @property
    def sigs(self) -> int:
        return sum(w.lanes for w in self.windows)


@dataclass
class PipelineResult(ReplayResult):
    """`replay_pipelined`'s result: per stage its host seconds summed over
    windows (discarded ones included; verify is dispatch plus collect and
    tally, the card's time runs under the other stages), the wall time,
    how many times the windows ahead were discarded and prepared again
    against the live validator set, and whether `stop_when` ended the
    run."""
    wall_s: float = 0.0
    busy_s: dict = field(default_factory=lambda: {
        "prepare": 0.0, "verify": 0.0, "apply": 0.0})
    redone: int = 0
    stopped: bool = False

    @property
    def overlap(self) -> float:
        """Busy seconds of all stages over the wall time: the host stages
        share one thread, so at most 1, the rest being the loop's own
        time."""
        return sum(self.busy_s.values()) / self.wall_s if self.wall_s else 0.0


def payload_txs(height: int, payload: int) -> list[bytes]:
    """One tx per block carrying `payload` bytes on a reused key, so the
    kvstore does the same work at every height (`bench.py` txs_for)."""
    return [b"p=%d:" % height + b"\xaa" * payload]


def make_block(chain_id: str, height: int, txs: list[bytes],
               last_block_id: BlockID, n_vals: int, vals_hash: bytes,
               app_hash: bytes) -> tuple[Block, BlockID]:
    """The block at `height` carrying `txs`, hash-linked to
    `last_block_id`, with an unsigned embedded last commit of `n_vals`
    slots (callers verify seen commits, or none) and the fixture's clock
    (1 s + height ns).  Returns (block, its BlockID with the part-set
    header)."""
    last_commit = (EMPTY_COMMIT if height == 1 else
                   Commit(block_id=last_block_id,
                          precommits=[None] * n_vals))
    block = Block.make(chain_id=chain_id, height=height,
                       time_ns=1_000_000_000 + height, txs=txs,
                       last_commit=last_commit,
                       last_block_id=last_block_id,
                       validators_hash=vals_hash, app_hash=app_hash)
    return block, BlockID(block.hash(), block.make_part_set().header)


def build_chain(n_vals: int, n_blocks: int, backend, payload: int = 12 * 1024,
                chain_id: str = "bench-chain", power: int = 10) -> Chain:
    """Deterministic chain of `n_blocks` blocks signed by `n_vals`
    validators (seed bytes [1, i+1] + 30 zeros, as the reference's
    `make_validators`).  Pass 1 builds hash-linked blocks whose embedded
    last commits are unsigned (the replay verifies each block's SEEN
    commit, as the reference's sync loop verifies a +2/3 commit per
    block); pass 2 signs all n_blocks x n_vals precommits with
    `backend.sign_grouped_templated` and spot-checks 16 lanes against the
    golden verifier."""
    seeds = [bytes([1, i + 1]) + b"\0" * 30 for i in range(n_vals)]
    pubs = [ref.pubkey_from_seed(s) for s in seeds]
    genesis = GenesisDoc(
        chain_id=chain_id,
        validators=[GenesisValidator(p, power) for p in pubs],
        genesis_time_ns=1_000_000_000)
    vs = genesis.validator_set()
    by_pub = dict(zip(pubs, seeds))
    seeds = [by_pub[v.pub_key.bytes_] for v in vs.validators]

    app = create_app("kvstore")
    app_hashes = [b""]
    for h in range(1, n_blocks):
        for tx in payload_txs(h, payload):
            app.deliver_tx(tx)
        app_hashes.append(app.commit().data)

    gc.disable()       # many long-lived objects; re-enabled below
    try:
        vals_hash = vs.hash()
        blocks, bids = [], []
        last_block_id = ZERO_BLOCK_ID
        for h in range(1, n_blocks + 1):
            block, bid = make_block(chain_id, h, payload_txs(h, payload),
                                    last_block_id, n_vals, vals_hash,
                                    app_hashes[h - 1])
            blocks.append(block)
            bids.append(bid)
            last_block_id = bid
    finally:
        gc.enable()

    bh = np.frombuffer(b"".join(b.hash for b in bids),
                       np.uint8).reshape(n_blocks, 32)
    ph = np.frombuffer(b"".join(b.parts.hash for b in bids),
                       np.uint8).reshape(n_blocks, 32)
    pt = np.array([b.parts.total for b in bids], np.int64)
    templates = canonical.batch_sign_bytes(
        chain_id, np.full(n_blocks, canonical.TYPE_PRECOMMIT, np.int64),
        np.arange(1, n_blocks + 1, dtype=np.int64),
        np.zeros(n_blocks, np.int64), bh, ph, pt)
    sigs = np.zeros((n_blocks * n_vals, 64), np.uint8)
    val_idx = np.tile(np.arange(n_vals, dtype=np.int32), SIGN_CHUNK_BLOCKS)
    for off in range(0, n_blocks, SIGN_CHUNK_BLOCKS):
        nb = min(SIGN_CHUNK_BLOCKS, n_blocks - off)
        sigs[off * n_vals:(off + nb) * n_vals] = \
            backend.sign_grouped_templated(
                seeds, val_idx[:nb * n_vals],
                np.repeat(np.arange(nb, dtype=np.int32), n_vals),
                templates[off:off + nb])
    pubs_vs = [v.pub_key.bytes_ for v in vs.validators]
    rng = np.random.default_rng(3)
    for i in rng.integers(0, len(sigs), 16):
        v, h = int(i) % n_vals, int(i) // n_vals
        if not ref.verify(pubs_vs[v], templates[h].tobytes(),
                          sigs[int(i)].tobytes()):
            raise RuntimeError(f"fixture lane {int(i)} does not verify")
    present = np.ones(n_vals, dtype=bool)
    commits = [CompactCommit(block_id=bids[h], height_=h + 1, round_=0,
                             sigs=sigs[h * n_vals:(h + 1) * n_vals],
                             present=present)
               for h in range(n_blocks)]
    return Chain(genesis=genesis, seeds=seeds, blocks=blocks,
                 commits=commits)


def prepare_window(blocks: list[Block], commits: list, vals_hash: bytes,
                   backend) -> tuple:
    """Cut the window at the first block whose header names another
    validator set (later blocks verify against the updated state), re-hash
    the part sets, and pair each block ID with its commit.  Returns
    (blocks, part_sets, items); items are (block_id, height, commit)."""
    cut = len(blocks)
    for i, b in enumerate(blocks):
        if b.header.validators_hash != vals_hash:
            cut = i
            break
    blocks = blocks[:cut]
    parts = from_data_batched([b.encode() for b in blocks], backend=backend)
    items = [(BlockID(b.hash(), ps.header), b.height, c)
             for b, ps, c in zip(blocks, parts, commits)]
    return blocks, parts, items


def replay(state, proxy_consensus, blocks: list[Block], commits: list,
           backend, window: int = DEFAULT_WINDOW) -> ReplayResult:
    """Replay `blocks` (with their seen `commits`) onto `state` window by
    window: prepare, verify every commit of the window in one backend call,
    apply.  Raises the canonical commit errors (`CommitSignatureError`,
    `CommitPowerError`, `CommitFormatError`) naming the failing height."""
    result = ReplayResult(height=state.last_block_height,
                          app_hash=state.app_hash)
    i = 0
    while i < len(blocks):
        t0 = time.perf_counter()
        first = blocks[i].height
        with tracing.span("fastsync.prepare", first_height=first,
                          blocks=len(blocks[i:i + window])):
            win, parts, items = prepare_window(
                blocks[i:i + window], commits[i:i + window],
                state.validators.hash(), backend)
        if not win:
            raise ValueError(f"block {blocks[i].height}: validators_hash "
                             f"does not match the state's validator set")
        t1 = time.perf_counter()
        with tracing.span("fastsync.verify", first_height=first,
                          blocks=len(win)):
            lanes, tallied = verify_commits_batched(
                state.validators, state.chain_id, items, backend)
        t2 = time.perf_counter()
        with tracing.span("fastsync.apply", first_height=first,
                          blocks=len(win)):
            execution.apply_window(
                state, proxy_consensus,
                [(b, ps.header) for b, ps in zip(win, parts)],
                execution.MockMempool(), save_every=0)
        t3 = time.perf_counter()
        tracing.RECORDER.record("fastsync.window", tracing.perf_to_epoch(t0),
                                t3 - t0, {"window": first,
                                          "blocks": len(win)})
        result.windows.append(WindowStats(
            win[0].height, len(win), lanes, [int(x) for x in tallied],
            t1 - t0, t2 - t1, t3 - t2))
        i += len(win)
    result.height = state.last_block_height
    result.app_hash = state.app_hash
    return result


@dataclass
class _Window:
    """One window dispatched ahead.  `vals_hash` names the validator-set
    snapshot it was prepared and verified against; an empty `blocks`
    marks a window whose first block names another set; `collect` returns
    its K1 mask; `error` is the window's verdict error (a `ValueError`: a
    bad commit, a malformed one, a bad index), raised only if the window
    turns out to be the live one."""
    first_height: int
    vals_hash: bytes
    blocks: list = field(default_factory=list)
    parts: list = field(default_factory=list)
    items: list = field(default_factory=list)
    lanes: tuple = ()
    collect: Callable | None = None
    tallied: list = field(default_factory=list)
    error: BaseException | None = None
    prepare_s: float = 0.0
    verify_s: float = 0.0
    t0: float = 0.0                     # perf_counter at its prepare


def _bounds(blocks: list[Block], start: int, vals_hash: bytes,
            window: int) -> deque:
    """The windows of blocks[start:] that name the set `vals_hash`, as
    (lo, hi), ending at the first block naming another set with an empty
    window there."""
    end = next((j for j in range(start, len(blocks))
                if blocks[j].header.validators_hash != vals_hash),
               len(blocks))
    bounds = deque((lo, min(lo + window, end))
                   for lo in range(start, end, window))
    if end < len(blocks):
        bounds.append((end, end))
    return bounds


def _dispatch(blocks, commits, lo: int, hi: int, vals, vals_hash: bytes,
              chain_id: str, backend, busy: dict) -> _Window:
    """Prepare blocks[lo:hi] against the set snapshot `vals` and dispatch
    its K1 call without waiting for it.  A verdict error is kept on the
    window; a failed launch or copy raises."""
    t0 = time.perf_counter()
    w = _Window(blocks[lo].height, vals_hash, t0=t0)
    if lo < hi:
        with tracing.span("fastsync.prepare", first_height=w.first_height,
                          blocks=hi - lo):
            try:
                w.blocks, w.parts, w.items = prepare_window(
                    blocks[lo:hi], commits[lo:hi], vals_hash, backend)
                w.lanes = window_commit_lanes(vals, chain_id, w.items)
            except ValueError as e:     # raised if this window is live
                w.error = e
    t1 = time.perf_counter()
    w.prepare_s = t1 - t0
    if w.blocks and w.error is None:
        templates, tmpl_idx, sigs, idxs = w.lanes[:4]
        # a replay window is one whole K1 call dispatched ahead of the
        # applied one: nothing to coalesce with, on the backend's stream
        # tmlint: disable=batchplane-producer
        w.collect = backend.verify_grouped_templated_async(
            vals.set_key(), vals.pubs_matrix(), idxs, tmpl_idx, templates,
            sigs)
        w.verify_s = time.perf_counter() - t1
    busy["prepare"] += w.prepare_s
    busy["verify"] += w.verify_s
    return w


def _verdict(w: _Window, vals, busy: dict) -> None:
    """Raise the live window's error, or collect its mask and tally it
    (`window_tally_check`)."""
    if w.error is not None:
        raise w.error
    if not w.blocks:
        raise ValueError(f"block {w.first_height}: validators_hash does "
                         f"not match the state's validator set")
    t0 = time.perf_counter()
    ok = w.collect()
    counts, tallied, foreign = w.lanes[4:]
    window_tally_check(w.items, ok, counts, tallied, foreign,
                       vals.total_voting_power())
    w.tallied = [int(x) for x in tallied]
    dt = time.perf_counter() - t0
    w.verify_s += dt
    busy["verify"] += dt


def replay_pipelined(state, proxy_consensus, blocks: list[Block],
                     commits: list, backend, window: int = DEFAULT_WINDOW,
                     store=None, stop_when=None) -> PipelineResult:
    """Replay `blocks` (with their seen `commits`) onto `state` like
    `replay`, with each window's K1 call dispatched ahead of its apply
    (the dispatch-ahead of `bench.py` `_replay_chain`, the semantics of
    the fast-sync reactor).  One thread prepares a window (part sets,
    `window_commit_lanes`) and dispatches its K1 call
    (`verify_grouped_templated_async`) until `PIPELINE_DEPTH` are in
    flight, then collects the oldest, runs `window_tally_check` and
    applies it (`apply_window`), so the card verifies while the host
    prepares and applies.

    Windows are verified against a snapshot of the validator set; a
    window is applied only if the live set's hash and the next height
    still match it (the reactor's rule, `reactor.py:262-277`), and
    otherwise the windows ahead are dropped and prepared again against
    the live set (counted in `redone`).  The set changing inside a window
    stops it (`_valset_moved`).  Errors are the serial loop's
    (`CommitSignatureError`, `CommitPowerError`, `CommitFormatError`,
    naming the same height and lane), raised after the windows before
    the failing one are applied; a failed launch or copy raises at once.

    With a `store` (`BlockStore`) each block is saved to it before it is
    applied and the state is saved after every block (`save_every=1`), so
    a restart's handshake can recover; without one the state is saved
    once per window.  `stop_when()`, checked after each applied block,
    ends the run early.
    """
    result = PipelineResult(height=state.last_block_height,
                            app_hash=state.app_hash)
    base = blocks[0].height if blocks else 0
    if blocks and base != state.last_block_height + 1:
        raise ValueError(f"wrong height {base}, expected "
                         f"{state.last_block_height + 1}")
    busy = result.busy_s
    ahead: deque = deque()
    todo: deque = deque()
    t_start = time.perf_counter()
    try:
        while (not result.stopped and
               state.last_block_height + 1 - base < len(blocks)):
            if not ahead and not todo:
                vals = state.validators.copy()
                vals_hash = vals.hash()
                todo = _bounds(blocks, state.last_block_height + 1 - base,
                               vals_hash, window)
            while todo and len(ahead) < PIPELINE_DEPTH:
                ahead.append(_dispatch(blocks, commits, *todo.popleft(),
                                       vals, vals_hash, state.chain_id,
                                       backend, busy))
            w = ahead.popleft()
            if (w.first_height != state.last_block_height + 1 or
                    w.vals_hash != state.validators.hash()):
                result.redone += 1
                ahead.clear()
                todo.clear()
                continue
            _verdict(w, vals, busy)
            _apply(state, proxy_consensus, w, store, stop_when, result)
    finally:
        result.wall_s = time.perf_counter() - t_start
    result.height = state.last_block_height
    result.app_hash = state.app_hash
    return result


def _apply(state, proxy_consensus, w: _Window, store, stop_when,
           result: PipelineResult) -> None:
    """Apply the live window `w`, storing each block first when there is
    a `store`, until it ends, the validator set moves or `stop_when`
    fires."""
    by_height = {b.height: (ps, c) for b, ps, (_, _, c)
                 in zip(w.blocks, w.parts, w.items)}

    def save(b, _psh):
        # store before state: the handshake recovers store == state + 1
        if store.height < b.height:
            ps, c = by_height[b.height]
            store.save_block(b, ps, c, validators=state.validators)

    def stop() -> bool:
        if state.validators.hash() != w.vals_hash:
            return True     # the rest was verified against a stale set
        result.stopped = stop_when is not None and stop_when()
        return result.stopped

    t0 = time.perf_counter()
    with tracing.span("fastsync.apply", first_height=w.first_height,
                      blocks=len(w.blocks)):
        applied = execution.apply_window(
            state, proxy_consensus,
            [(b, ps.header) for b, ps in zip(w.blocks, w.parts)],
            execution.MockMempool(), save_every=1 if store else 0,
            before_block=save if store else None, stop_when=stop)
    t1 = time.perf_counter()
    apply_s = t1 - t0
    tracing.RECORDER.record("fastsync.window", tracing.perf_to_epoch(w.t0),
                            t1 - w.t0, {"window": w.first_height,
                                        "blocks": applied})
    result.busy_s["apply"] += apply_s
    result.windows.append(WindowStats(
        w.first_height, applied, int(sum(w.lanes[4][:applied])),
        w.tallied[:applied], w.prepare_s, w.verify_s, apply_s))
