"""BlockchainReactor: fast-sync — batched block download + verified replay.

Reference: `blockchain/reactor.go` — `poolRoutine` (`:169-257`) with the
SYNC_LOOP hot loop (`:213-252`): peek blocks, re-hash the part set,
`Validators.VerifyCommit` against the NEXT block's LastCommit, save,
ApplyBlock; status exchange and the switch-to-consensus ticker
(`:196-212`); channel 0x40 (`:19`).

Copy of `tendermint_tpu/blockchain/reactor.py`.  The loop drains a
contiguous WINDOW of K downloaded blocks and verifies all their commit
signatures in ONE grouped call on the backend it is given
(`verify_commits_batched`, kernel K1 on `CudaBackend`), then applies them
in order.  Two differences, both rules of the port:

- The next window is verified ahead by a dispatch on the backend's
  asynchronous route (`verify_grouped_templated_async`, the route
  `replay_pipelined` uses), prepared against a snapshot of the validator
  set after the current window is verified and collected at the next
  `_sync_step`, so the card verifies while the host applies; the JAX
  reactor runs that verify in a Python thread (`_Lookahead`).  The drop
  rule is the JAX one: the result is used only if the set's hash and the
  first height still match, and on any mismatch or verdict error the
  synchronous path verifies again and owns the blame.
- No fallback hides the card: the JAX loop logs any error of a sync step
  and retries on a `DeviceFault`.  Here an error that is not a peer's
  (a kernel that fails to build or launch, the app) ends the routine,
  stays on the reactor as `fault`, and `stop()` raises it; no peer is
  blamed.  A bad commit still takes the JAX blame path (`pool.redo`,
  eviction, ban).

The JAX reactor's spans are kept (`fastsync.lookahead`, `.prepare`,
`.verify`, `.apply` and the `fastsync.window` envelope the attribution
doctor groups by), with `blocks_synced` and each window's attribution fed
to the `window_*` histograms; each window's host seconds are also kept
in `windows`.
"""

from __future__ import annotations

import threading
import time

from tendermint_tpu_torch.blockchain import messages as BM
from tendermint_tpu_torch.blockchain.pool import BlockPool
from tendermint_tpu_torch.blockchain.replay import WindowStats
from tendermint_tpu_torch.p2p.peer import Peer, Reactor
from tendermint_tpu_torch.p2p.types import ChannelDescriptor
from tendermint_tpu_torch.state import execution
from tendermint_tpu_torch.types import BlockID
from tendermint_tpu_torch.types.part_set import from_data_batched
from tendermint_tpu_torch.types.validator import (CommitFormatError,
                                                  CommitPowerError,
                                                  CommitSignatureError,
                                                  verify_commits_batched,
                                                  window_commit_lanes,
                                                  window_tally_check)
from tendermint_tpu_torch.utils import attribution, tracing
from tendermint_tpu_torch.utils.log import get_logger
from tendermint_tpu_torch.utils.metrics import REGISTRY

log = get_logger("blockchain")

# spans a window's attribution reads back from the recorder: its own
# handful and whatever other threads recorded meanwhile
WINDOW_SPANS = 256

BLOCKCHAIN_CHANNEL = 0x40
SYNC_TICK = 0.01                 # reference trySyncTicker (100ms)
STATUS_INTERVAL = 2.0            # reference statusUpdateTicker (10s)
DEFAULT_BATCH = 64               # blocks verified per device call


class _Lookahead:
    """The NEXT sync window, prepared (part sets re-hashed, lanes built)
    against a validator set SNAPSHOT and its grouped verify dispatched on
    the backend's asynchronous route without waiting; `check` collects
    the mask and tallies it.  A verdict error of the preparation is kept
    on `error`, not acted on; a failed launch or copy raises."""

    def __init__(self, vals, chain_id: str, blocks, backend):
        self.vals_hash = vals.hash()
        self.first_height = blocks[0].height
        self.total = vals.total_voting_power()
        self.window = None
        self.parts_list = None
        self.items = None
        self.lanes = None
        self.collect = None
        self.error: BaseException | None = None
        self.prepare_s = 0.0
        t0 = time.perf_counter()
        with tracing.span("fastsync.lookahead",
                          first_height=self.first_height,
                          blocks=len(blocks)):
            try:
                window, parts_list, items = \
                    BlockchainReactor._prepare_window(blocks, self.vals_hash,
                                                      backend)
                if window:
                    self.lanes = window_commit_lanes(vals, chain_id, items)
            except ValueError as e:
                self.error = e
                return
            finally:
                self.prepare_s = time.perf_counter() - t0
            self.window, self.parts_list, self.items = (window, parts_list,
                                                        items)
            if window:
                templates, tmpl_idx, sigs, idxs = self.lanes[:4]
                # the next window verified ahead on the backend's own
                # stream: one whole K1 call, nothing to coalesce with
                # tmlint: disable=batchplane-producer
                self.collect = backend.verify_grouped_templated_async(
                    vals.set_key(), vals.pubs_matrix(), idxs, tmpl_idx,
                    templates, sigs)

    def check(self) -> None:
        """Wait for the mask and tally it: raises the window's canonical
        commit error (`window_tally_check`)."""
        ok = self.collect()
        counts, tallied, foreign = self.lanes[4:]
        window_tally_check(self.items, ok, counts, tallied, foreign,
                           self.total)


class BlockchainReactor(Reactor):
    def __init__(self, state, proxy_consensus, block_store,
                 fast_sync: bool = True, batch_size: int = DEFAULT_BATCH,
                 *, backend):
        super().__init__()
        self.state = state
        self.proxy = proxy_consensus
        self.store = block_store
        self.backend = backend
        self.fast_sync = fast_sync
        self.batch_size = batch_size
        # a snapshot-restored node's state can be AHEAD of its (pruned /
        # freshly bootstrapped) block store — sync from whichever cursor
        # is further along, never re-request blocks the state already
        # executed
        self.pool = BlockPool(
            max(block_store.height, state.last_block_height) + 1)
        self.pool.on_evict = self._on_pool_evict
        self.on_caught_up = None          # cb(state) -> switch_to_consensus
        self._stopped = threading.Event()
        self._thread: threading.Thread | None = None
        self._switched = False
        self._lookahead: _Lookahead | None = None
        self.lookahead_hits = 0     # speculative windows actually consumed
        # the error that ended the sync routine (`stop` raises it)
        self.fault: BaseException | None = None
        self.windows: list[WindowStats] = []    # one per applied window

    def get_channels(self):
        return [ChannelDescriptor(id=BLOCKCHAIN_CHANNEL, priority=5,
                                  send_queue_capacity=100,
                                  recv_message_capacity=32 << 20)]

    def start(self) -> None:
        if self.fast_sync:
            self._thread = threading.Thread(target=self._pool_routine,
                                            daemon=True, name="fast-sync")
            self._thread.start()

    def stop(self) -> None:
        """Stop the sync routine; raise the fault that ended it, if one
        did."""
        self._stopped.set()
        t = self._thread
        if (t is not None and t.is_alive() and
                t is not threading.current_thread()):
            t.join(timeout=10)
        if self.fault is not None:
            raise self.fault

    # -- peer lifecycle -------------------------------------------------
    def add_peer(self, peer: Peer) -> None:
        # advertise our height; ask for theirs (reference :96-106)
        peer.try_send(BLOCKCHAIN_CHANNEL,
                      BM.encode_msg(BM.StatusResponse(self.store.height)))
        peer.try_send(BLOCKCHAIN_CHANNEL,
                      BM.encode_msg(BM.StatusRequest()))

    def remove_peer(self, peer: Peer, reason) -> None:
        self.pool.remove_peer(peer.id)

    def _on_pool_evict(self, peer_id: str, reason: str) -> None:
        if self.switch is None:
            return
        if reason.startswith("bad block"):
            # a PROVEN commit lie (the typed commit checks — format /
            # signature / power — failed on a block this peer served):
            # immediate ban, not just a strike.  Timeout evictions land
            # in the else-branch: slow is not malicious, no strike.
            if self.switch.report_misbehavior(peer_id, reason, ban=True):
                return               # report_misbehavior already removed it
        p = self.switch.get_peer(peer_id)
        if p is not None:
            self.switch.stop_peer_for_error(p, reason)

    # -- inbound --------------------------------------------------------
    def receive(self, ch_id: int, peer: Peer, raw: bytes) -> None:
        try:
            msg = BM.decode_msg(raw)
        except (ValueError, IndexError) as e:
            # an undecodable message on an authenticated channel is the
            # peer's doing — one strike
            self.switch.report_misbehavior(peer.id, f"bad bc msg: {e}")
            self.switch.stop_peer_for_error(peer, f"bad bc msg: {e}")
            return
        if isinstance(msg, BM.BlockRequest):
            block = (self.store.load_block(msg.height)
                     if msg.height <= self.store.height else None)
            if block is not None:
                peer.try_send(BLOCKCHAIN_CHANNEL, BM.encode_msg(
                    BM.BlockResponse(block.encode())))
            else:
                peer.try_send(BLOCKCHAIN_CHANNEL, BM.encode_msg(
                    BM.NoBlockResponse(msg.height)))
        elif isinstance(msg, BM.BlockResponse):
            try:
                block = msg.block()
            except (ValueError, IndexError) as e:
                self.switch.report_misbehavior(peer.id, f"bad block: {e}")
                self.switch.stop_peer_for_error(peer, f"bad block: {e}")
                return
            if self.pool.add_block(peer.id, block):
                # feed the peer's flowrate meter — the slow-drip
                # eviction (reference minRecvRate) keys off this
                self.pool.record_bytes(peer.id, len(raw))
        elif isinstance(msg, BM.StatusRequest):
            peer.try_send(BLOCKCHAIN_CHANNEL, BM.encode_msg(
                BM.StatusResponse(self.store.height)))
        elif isinstance(msg, BM.StatusResponse):
            self.pool.set_peer_height(peer.id, msg.height)

    # -- the sync loop ---------------------------------------------------
    def _pool_routine(self) -> None:
        try:
            self._pool_loop()
        except BaseException as e:
            # not a peer's doing (a bad commit is handled in _sync_step):
            # the sync ends here and stop() raises it
            log.error("fast-sync stopped by a fault",
                      height=self.pool.next_height, error=repr(e))
            self.fault = e

    def _pool_loop(self) -> None:
        """Reference `poolRoutine` :169-257."""
        last_status = 0.0
        while not self._stopped.is_set():
            now = time.monotonic()
            if now - last_status >= STATUS_INTERVAL:
                if self.switch is not None:
                    self.switch.broadcast(
                        BLOCKCHAIN_CHANNEL,
                        BM.encode_msg(BM.StatusRequest()))
                last_status = now
            self._send_requests()
            progressed = self._sync_step()
            if self.pool.is_caught_up() and not self._switched:
                self._switched = True
                log.info("fast-sync caught up",
                         height=self.state.last_block_height)
                if self.on_caught_up is not None:
                    self.on_caught_up(self.state)
                return
            if not progressed:
                time.sleep(SYNC_TICK)

    def _send_requests(self) -> None:
        if self.switch is None:
            return
        for height, peer_id in self.pool.schedule():
            peer = self.switch.get_peer(peer_id)
            if peer is not None:
                peer.try_send(BLOCKCHAIN_CHANNEL,
                              BM.encode_msg(BM.BlockRequest(height)))

    @staticmethod
    def _prepare_window(blocks, vals_hash: bytes, backend):
        """Cut the window at the first valset change, re-hash part sets in
        one batch on `backend`, and assemble verify items.

        Each header commits to the validator set of ITS height.  EndBlock
        diffs can change the set mid-window, so only the prefix whose
        headers match vals_hash is prepared; the rest re-verifies next
        tick against the updated state (reference verifies per block:
        `blockchain/reactor.go:230-231`).  Returns (window, parts_list,
        items); an empty window means the very next block mismatches.
        """
        window = blocks[:-1]              # each needs its successor's
        cut = len(window)                 # LastCommit as its +2/3 proof
        for i, b in enumerate(window):
            if b.header.validators_hash != vals_hash:
                cut = i
                break
        window = window[:cut]
        parts_list = from_data_batched([b.encode() for b in window],
                                       backend=backend)
        items = []
        for i, b in enumerate(window):
            bid = BlockID(b.hash(), parts_list[i].header)
            items.append((bid, b.height, blocks[i + 1].last_commit))
        return window, parts_list, items

    def _sync_step(self) -> bool:
        """Drain one verified window: batch-verify K contiguous blocks'
        commits in one grouped call, then save + apply each — with the
        NEXT window's verify dispatched ahead on the card while this one
        applies (dropped if the validator set moved)."""
        peek = self.pool.peek_contiguous(2 * (self.batch_size + 1))
        if len(peek) < 2:
            return False
        blocks = peek[:self.batch_size + 1]
        chain_id = self.state.chain_id
        vals_hash = self.state.validators.hash()
        verified = None
        t0 = time.perf_counter()
        prepare_s = 0.0                  # this step's synchronous prepare
        la, self._lookahead = self._lookahead, None
        if (la is not None and la.error is None and la.window and
                la.vals_hash == vals_hash and
                la.first_height == blocks[0].height):
            try:
                with tracing.span("fastsync.verify",
                                  first_height=la.first_height,
                                  blocks=len(la.window)):
                    la.check()
            except ValueError:
                # the synchronous path below verifies again and blames
                pass
            else:
                verified = (la.window, la.parts_list, la.items)
                self.lookahead_hits += 1
        if verified is None:
            with tracing.span("fastsync.prepare",
                              first_height=blocks[0].height,
                              blocks=len(blocks) - 1):
                window, parts_list, items = self._prepare_window(
                    blocks, vals_hash, self.backend)
            prepare_s = time.perf_counter() - t0
            if not window:
                # the very next block disagrees with our state's validator
                # set: the block is bad (or stale) — re-fetch it elsewhere
                log.warn("next block's validators_hash mismatches state",
                         height=blocks[0].height)
                self.pool.redo(blocks[0].height)
                return False
            try:
                with tracing.span("fastsync.verify",
                                  first_height=window[0].height,
                                  blocks=len(window)):
                    verify_commits_batched(self.state.validators, chain_id,
                                           items, self.backend)
            except CommitFormatError as e:
                # a structurally-wrong commit (stale finality proof, bad
                # size) rides in the successor block's LastCommit — same
                # blame as a pruned commit: height+1's deliverer lied
                log.warn("stale/malformed commit; punishing successor's "
                         "deliverer", height=e.height, error=str(e)[:200])
                self.pool.redo(e.height + 1)
                return False
            except CommitSignatureError as e:
                # the commit for height h rides in block h+1's LastCommit:
                # a forged signature implicates the successor's deliverer
                log.warn("bad commit signature; punishing deliverer",
                         height=e.height)
                self.pool.redo(e.height + 1)
                return False
            except CommitPowerError as e:
                if e.foreign_votes:
                    # votes endorse a DIFFERENT block: block h itself was
                    # tampered — its deliverer lied
                    log.warn("commit votes for another block; punishing "
                             "deliverer", height=e.height)
                    self.pool.redo(e.height)
                else:
                    # every vote endorses our block but too few are
                    # present: the commit rides in h+1's LastCommit, so
                    # the SUCCESSOR's deliverer pruned it — an honest
                    # deliverer of h must not be evicted for that
                    log.warn("commit pruned; punishing successor's "
                             "deliverer", height=e.height)
                    self.pool.redo(e.height + 1)
                return False
            verified = (window, parts_list, items)
        window, parts_list, items = verified
        t1 = time.perf_counter()
        # verify-ahead: the next contiguous window, against a SNAPSHOT of
        # the current set (apply below mutates the live one)
        nxt = peek[len(window):len(window) + self.batch_size + 1]
        if len(nxt) >= 2 and not self._stopped.is_set():
            self._lookahead = _Lookahead(
                self.state.validators.copy(), chain_id, nxt, self.backend)
        t2 = time.perf_counter()
        commit_by_height = {h: c for _bid, h, c in items}
        parts_by_height = {b.height: p for b, p in zip(window, parts_list)}

        def _save_to_store(b, _psh):
            # store-before-state is the crash-recovery discipline (the
            # handshake covers store==state+1)
            if self.store.height < b.height:
                self.store.save_block(b, parts_by_height[b.height],
                                      commit_by_height[b.height])

        def _valset_moved():
            # validator set changed: the rest of the window was verified
            # against a stale set — drop and re-verify
            moved = self.state.validators.hash() != vals_hash
            if moved:
                log.info("valset changed mid-window; flushing",
                         height=self.state.last_block_height)
            return moved

        # the window-batched apply: per-block validate/exec/save
        # discipline identical to apply_block (save_every=1 — a durable
        # node must keep store <= state+1 for the handshake), but the app
        # conn's lock is held once for the whole window
        with tracing.span("fastsync.apply", first_height=window[0].height,
                          blocks=len(window)):
            applied = execution.apply_window(
                self.state, self.proxy,
                [(b, p.header) for b, p in zip(window, parts_list)],
                execution.MockMempool(), save_every=1,
                before_block=_save_to_store, stop_when=_valset_moved)
        self.pool.pop(applied)
        REGISTRY.blocks_synced.inc(applied)
        t3 = time.perf_counter()
        # the window-boundary span: verify (or the lookahead's collect)
        # through apply under one window=<first_height> key, which is
        # what the attribution profiler groups by
        tracing.RECORDER.record(
            "fastsync.window", tracing.perf_to_epoch(t0), t3 - t0,
            {"window": window[0].height, "blocks": applied})
        spans = tracing.RECORDER.recent(WINDOW_SPANS)
        iv = attribution.find_windows(spans).get(window[0].height)
        if iv is not None:
            attribution.observe_window_metrics(attribution.attribute_interval(
                attribution.spans_by_category(spans), *iv))
        # host seconds of this step: preparing (a window verified here
        # and the next one's dispatch), verifying (or collecting the
        # window verified ahead), applying
        self.windows.append(WindowStats(
            window[0].height, applied,
            sum(v is not None for _b, _h, c in items[:applied]
                for v in c.precommits), [],
            prepare_s + (t2 - t1), t1 - t0 - prepare_s, t3 - t2))
        return True
