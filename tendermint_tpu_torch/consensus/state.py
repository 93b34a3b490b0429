"""The Tendermint BFT round state machine.

Reference: `consensus/state.go` (1620 LoC) — steps NewHeight -> Propose ->
Prevote -> PrevoteWait -> Precommit -> PrecommitWait -> Commit (`:47-57`);
a single serialized receive loop consumes peer messages, own messages, and
timeouts (`receiveRoutine` `:617-661`) so every state transition is
deterministic and WAL-replayable; POL lock/unlock rules (`:1497-1526`);
proposal creation (`createProposalBlock` `:961-981`); finalize + ApplyBlock
(`finalizeCommit` `:1259-1356`).

Copy of `tendermint_tpu/consensus/state.py`.  The transitions carry the
reference's names and ordering; the WAL records every input before it is
handled; own messages loop back through the same queue as peer messages.
Signatures are checked on the batch plane the state is given: a burst of
votes in one grouped call at the consensus class (kernel K1 with per-lane
keys on `CudaBackend`), each block's LastCommit at the fast-sync class
(templated K1).  The height-lifecycle telemetry, metrics and fail points
of the JAX package are not ported.

No fallback hides the plane: an error out of a plane verify is a
`PlaneFault`, which no handler of bad input catches.  It ends the receive
routine, stays on the state as `fault`, and `stop()` raises it again;
the JAX package instead goes scalar on any pre-verify error
(`_handle_vote_run`) or on a `DeviceFault` (`_batch_preverify`).
"""

from __future__ import annotations

import logging
import queue
import struct
import threading
import time
from dataclasses import dataclass
from types import SimpleNamespace

from tendermint_tpu_torch import config as config_mod
from tendermint_tpu_torch.batchplane import CLASS_FASTSYNC
from tendermint_tpu_torch.consensus import messages as M
from tendermint_tpu_torch.consensus.height_vote_set import HeightVoteSet
from tendermint_tpu_torch.consensus.ticker import TimeoutInfo, TimeoutTicker
from tendermint_tpu_torch.consensus.wal import WAL, REC_MESSAGE, REC_TIMEOUT
from tendermint_tpu_torch.state import execution
from tendermint_tpu_torch.state.state import State
from tendermint_tpu_torch.types import (Block, BlockID, EMPTY_COMMIT,
                                        PartSet, TYPE_PRECOMMIT, TYPE_PREVOTE,
                                        ZERO_BLOCK_ID)
from tendermint_tpu_torch.types import events as ev
from tendermint_tpu_torch.types.events import EventCache, EventSwitch
from tendermint_tpu_torch.types.priv_validator import DoubleSignError
from tendermint_tpu_torch.types.proposal import Heartbeat, Proposal
from tendermint_tpu_torch.types.vote import (ErrVoteConflict, Vote, VoteSet,
                                             batch_verify_vote_sigs)
from tendermint_tpu_torch.utils.fmt import bits_str

log = logging.getLogger(__name__)

# round steps (reference consensus/state.go:47-57)
STEP_NEW_HEIGHT = 1
STEP_NEW_ROUND = 2
STEP_PROPOSE = 3
STEP_PREVOTE = 4
STEP_PREVOTE_WAIT = 5
STEP_PRECOMMIT = 6
STEP_PRECOMMIT_WAIT = 7
STEP_COMMIT = 8

STEP_NAMES = {
    STEP_NEW_HEIGHT: "NewHeight", STEP_NEW_ROUND: "NewRound",
    STEP_PROPOSE: "Propose", STEP_PREVOTE: "Prevote",
    STEP_PREVOTE_WAIT: "PrevoteWait", STEP_PRECOMMIT: "Precommit",
    STEP_PRECOMMIT_WAIT: "PrecommitWait", STEP_COMMIT: "Commit",
}


@dataclass
class RoundStepEvent:
    height: int
    round: int
    step: int
    seconds_since_start: int
    last_commit_round: int


@dataclass(frozen=True)
class _TxsAvailable:
    """Internal queue marker: the mempool has txs for `height`."""
    height: int


PROPOSAL_HEARTBEAT_INTERVAL = 2.0   # reference consensus/state.go:28


class PlaneFault(RuntimeError):
    """A signature check on the batch plane failed (a kernel that did not
    build or launch, a bad argument): a fault of this node, not of the
    votes, so no handler of bad input catches it."""


def _on_plane(fn, *args):
    """`fn(*args)`, a verify on the batch plane, with its error raised as
    a `PlaneFault`."""
    try:
        return fn(*args)
    except Exception as e:
        raise PlaneFault(f"batch plane verify failed: {e!r}") from e


class _CommitVerifier:
    """The backend `ValidatorSet.verify_commit` checks a block's
    LastCommit through: the plane's templated lanes at the fast-sync
    class, as the JAX package's `verify_commit` submits them
    (`types/validator.py:466-487`)."""

    def __init__(self, plane):
        self.plane = plane

    def verify_grouped_templated(self, set_key, val_pubs, val_idx, tmpl_idx,
                                 templates, sigs):
        return _on_plane(lambda: self.plane.verify_grouped_templated(
            set_key, val_pubs, val_idx, tmpl_idx, templates, sigs,
            producer="fastsync", klass=CLASS_FASTSYNC))


class ConsensusState:
    """Single-node consensus core.  The reactor (gossip) layer plugs in via
    `broadcast_cb` (outbound messages) and the public feed methods
    (inbound); RPC reads via `get_round_state_summary`.  Every signature
    check runs on `plane`, a `batchplane.BatchPlane` that many states may
    share."""

    def __init__(self, cfg: config_mod.ConsensusConfig, state: State,
                 proxy_consensus, block_store, mempool, plane,
                 priv_validator=None, evsw: EventSwitch | None = None,
                 wal_path: str = "", tx_indexer=None, node_id: str = ""):
        self.cfg = cfg
        self.proxy = proxy_consensus
        self.block_store = block_store
        self.mempool = mempool
        self.plane = plane
        self.priv_validator = priv_validator
        self.evsw = evsw or EventSwitch()
        self.tx_indexer = tx_indexer
        self.node_id = node_id            # the node's moniker
        self.broadcast_cb = None          # reactor hook: fn(msg)
        # the plane error that ended the receive routine (`stop` raises it)
        self.fault: BaseException | None = None
        self._commit_verifier = _CommitVerifier(plane)

        self._queue: queue.Queue = queue.Queue(maxsize=10_000)
        self._ticker = TimeoutTicker(self._on_timeout_fire)
        self._thread: threading.Thread | None = None
        self._stopped = threading.Event()
        self._mtx = threading.RLock()

        self.wal = WAL(wal_path, light=cfg.wal_light) if wal_path else None
        self._replay_mode = False
        self._commit_step_bcast = 0.0   # last CommitStep broadcast
        # wait-for-txs (create_empty_blocks = false): the mempool's
        # height-gated txs-available notification unblocks enterPropose
        # (reference consensus/state.go:793-801); delivered through the
        # serialized queue like every other input
        if (not cfg.create_empty_blocks and
                hasattr(mempool, "set_txs_available_callback")):
            mempool.set_txs_available_callback(
                lambda h: self._queue.put(_TxsAvailable(h)))

        # --- RoundState (reference :89-106) ---
        self.height = 0
        self.round = 0
        self.step = STEP_NEW_HEIGHT
        self.start_time = 0.0
        self.commit_time = 0.0
        self.state: State | None = None
        self.validators = None
        self.proposal: Proposal | None = None
        self.proposal_block: Block | None = None
        self.proposal_block_parts: PartSet | None = None
        self.locked_round = -1
        self.locked_block: Block | None = None
        self.locked_block_parts: PartSet | None = None
        self.votes: HeightVoteSet | None = None
        self.commit_round = -1
        self.last_commit: VoteSet | None = None
        self._app_hash_changed: bool | None = None   # set per height

        self._update_to_state(state)
        self._reconstruct_last_commit(state)

    def _reconstruct_last_commit(self, state: State) -> None:
        """Rebuild last_commit from the stored SeenCommit after a restart
        (reference `reconstructLastCommit`, consensus/state.go:368-393):
        its signatures in one grouped verify on the plane, whose error
        is a `PlaneFault` raised out of the constructor."""
        if state.last_block_height == 0 or self.last_commit is not None:
            return
        seen = self.block_store.load_seen_commit(state.last_block_height)
        if seen is None:
            if state.last_block_height < getattr(self.block_store,
                                                 "base", 1):
                # snapshot-restored (or pruned) node: block H was never
                # stored here, so no SeenCommit exists; until fast-sync
                # brings H+1 (whose last_commit holds the +2/3 for H) the
                # node cannot propose — correct for a catching-up node
                return
            raise RuntimeError(
                f"no seen commit for height {state.last_block_height}")
        vset = VoteSet(state.chain_id, state.last_block_height, seen.round(),
                       TYPE_PRECOMMIT, state.last_validators)
        outcomes = _on_plane(vset.add_votes_batched,
                             [v for v in seen.precommits if v is not None],
                             self.plane)
        if not vset.has_two_thirds_majority():
            raise RuntimeError(
                f"seen commit does not have +2/3: {outcomes}")
        self.last_commit = vset

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    def start(self) -> None:
        if self._stopped.is_set():
            return
        if self.wal is not None:
            self._catchup_replay()
        t = threading.Thread(target=self._receive_routine,
                             daemon=True, name="consensus")
        t.start()
        # assign only after start: stop() may run concurrently and must
        # never join an unstarted thread
        self._thread = t
        self._schedule_round_0()

    def stop(self) -> None:
        """Stop the routine and close the WAL; raise the plane fault that
        ended the routine, if one did."""
        self._stopped.set()
        self._ticker.stop()
        if self._thread is not None and self._thread.is_alive():
            self._queue.put(None)
            self._thread.join(timeout=5)
        if self.wal is not None:
            self.wal.close()
        if self.fault is not None:
            raise self.fault

    # ------------------------------------------------------------------
    # public inbound API (thread-safe; reference :425-470)
    # ------------------------------------------------------------------
    def add_vote(self, vote: Vote, peer_id: str = "") -> None:
        self._queue.put((M.VoteMessage(vote), peer_id))

    def set_proposal(self, proposal: Proposal, peer_id: str = "") -> None:
        self._queue.put((M.ProposalMessage(proposal), peer_id))

    def add_proposal_block_part(self, height: int, round_: int, part,
                                peer_id: str = "") -> None:
        self._queue.put((M.BlockPartMessage(height, round_, part), peer_id))

    def set_peer_maj23(self, height, round_, type_, peer_id, block_id):
        with self._mtx:   # receive thread swaps self.votes on every height
            if height == self.height and self.votes is not None:
                self.votes.set_peer_maj23(round_, type_, peer_id, block_id)

    def get_round_state(self):
        """Shallow snapshot of the RoundState for gossip routines
        (reference `GetRoundState` consensus/state.go:292)."""
        with self._mtx:
            return SimpleNamespace(
                height=self.height, round=self.round, step=self.step,
                start_time=self.start_time, validators=self.validators,
                proposal=self.proposal,
                proposal_block_parts=self.proposal_block_parts,
                locked_round=self.locked_round, votes=self.votes,
                commit_round=self.commit_round,
                last_commit=self.last_commit)

    def get_round_state_summary(self) -> dict:
        with self._mtx:
            return {
                "height": self.height, "round": self.round,
                "step": STEP_NAMES.get(self.step, self.step),
                "proposal": (str(self.proposal)
                             if self.proposal else None),
                "locked_round": self.locked_round,
                "locked_block": (self.locked_block.hash().hex()
                                 if self.locked_block else None),
                "start_time": self.start_time,
            }

    def get_round_state_dump(self) -> dict:
        """Full RoundState for `dump_consensus_state` (reference
        `rpc/core/routes.go:21`): the summary plus per-round vote
        bit-arrays, the commit progress and the validator set."""
        with self._mtx:
            out = self.get_round_state_summary()
            hvs = self.votes
            votes = {}
            if hvs is not None:
                for r in range(self.round + 1):
                    pv, pc = hvs.prevotes(r), hvs.precommits(r)
                    votes[r] = {
                        "prevotes": str(pv) if pv else None,
                        "prevotes_bits": bits_str(pv.bit_array()
                                                  if pv else None),
                        "precommits": str(pc) if pc else None,
                        "precommits_bits": bits_str(pc.bit_array()
                                                    if pc else None),
                    }
            out["votes"] = votes
            out["commit_round"] = self.commit_round
            parts = self.proposal_block_parts
            out["proposal_block_parts"] = (
                None if parts is None else {
                    "header_hash": parts.header.hash.hex()[:16],
                    "have": parts.count,
                    "total": parts.total,
                })
            out["proposal_block_hash"] = (
                self.proposal_block.hash().hex()[:16]
                if self.proposal_block is not None else None)
            prop = self.validators._proposer   # may be None mid-update
            out["validators"] = {
                "size": self.validators.size(),
                "total_power": self.validators.total_voting_power(),
                "proposer": prop.address.hex() if prop is not None else None,
            }
            lc = self.last_commit
            out["last_commit"] = (bits_str(lc.bit_array())
                                  if lc is not None else None)
            return out

    def is_proposer(self) -> bool:
        return (self.priv_validator is not None and
                self.validators.proposer.address ==
                self.priv_validator.address)

    # ------------------------------------------------------------------
    # the serialized receive loop (reference :617-661)
    # ------------------------------------------------------------------
    # a consecutive run of queued votes at least this long is signature-
    # checked in ONE grouped call on the plane before sequential
    # accounting (SURVEY §7 hard-part 3: accumulation-window
    # micro-batching).  `_microbatch_threshold` applies it on a card.
    VOTE_MICROBATCH_MIN = 16
    _RECEIVE_DRAIN_MAX = 4096

    def _microbatch_threshold(self) -> int:
        """Votes a run needs before it is pre-verified on the plane.  Only
        a `CudaBackend` on a card batches: every other backend, a
        `CudaBackend` on the CPU among them, verifies on the scalar
        arrival path.  Before the backend has made two synchronous grouped
        calls (the first holds the kernels' build) the state stays scalar;
        then 16."""
        be = self.plane.backend
        on_card = getattr(getattr(be, "device", None), "type", "") == "cuda"
        if getattr(be, "name", "") != "cuda" or not on_card:
            return 1 << 30
        if be.step_count < 2:
            return 1 << 30
        # no breakeven term: the port's scalar verify is pure Python, so
        # any grouped call beats it
        return self.VOTE_MICROBATCH_MIN

    def _receive_routine(self) -> None:
        try:
            self._receive_loop()
        except PlaneFault as e:
            # a plane verify failed: stop handling input; stop() raises it
            log.error("consensus stopped by a batch plane fault: %s", e)
            self.fault = e

    def _receive_loop(self) -> None:
        while not self._stopped.is_set():
            item = self._queue.get()
            if item is None:
                return
            # opportunistic drain: under a vote burst (100+ validators
            # precommitting at once) the queue holds a run of
            # VoteMessages; pulling them now lets the run's signature
            # checks batch while preserving arrival order exactly
            batch = [item]
            while len(batch) < self._RECEIVE_DRAIN_MAX:
                try:
                    batch.append(self._queue.get_nowait())
                except queue.Empty:
                    break
            i = 0
            while i < len(batch):
                if batch[i] is None:
                    return
                j = i
                while (j < len(batch) and
                       isinstance(batch[j], tuple) and
                       isinstance(batch[j][0], M.VoteMessage)):
                    j += 1
                try:
                    if j > i:
                        self._handle_vote_run(batch[i:j])
                    else:
                        with self._mtx:
                            self._dispatch_one(batch[i])
                except PlaneFault:
                    raise
                except Exception:
                    # bad input must never kill the loop; the reference
                    # recovers the same way and relies on WAL replay for
                    # true corruption
                    log.exception("error handling consensus input at "
                                  "%d/%d %s", self.height, self.round,
                                  STEP_NAMES.get(self.step, self.step))
                i = max(j, i + 1)

    def _dispatch_one(self, item) -> None:
        if isinstance(item, TimeoutInfo):
            if self.wal is not None and not self._replay_mode:
                self.wal.save_timeout(item.height, item.round, item.step)
            self._handle_timeout(item)
        elif isinstance(item, _TxsAvailable):
            self._handle_txs_available(item)
        else:
            msg, peer_id = item
            if self.wal is not None and not self._replay_mode:
                if not (self.wal.light and
                        isinstance(msg, M.BlockPartMessage) and peer_id):
                    self.wal.save_message(M.encode_msg(msg))
            self._handle_msg(msg, peer_id)

    # accounting chunk per mutex acquisition: gossip routines snapshot
    # the round state under the same lock, so a multi-thousand-vote run
    # held under ONE acquisition would starve them for its whole length
    _VOTE_CHUNK_PER_LOCK = 64

    def _handle_vote_run(self, run: list) -> None:
        """A consecutive run of VoteMessages: batch-verify the
        signatures when the run is long enough, then do the per-vote
        accounting and state transitions IN ORDER — the transitions see
        exactly the sequence a scalar loop would, so WAL replay (which
        feeds records one at a time) reconstructs identical state.  Each
        vote is WAL-saved immediately before ITS handling.

        The pre-verify runs OUTSIDE self._mtx: it mutates nothing, and
        only this thread mutates consensus state; votes the accounting
        below obsoletes (height advanced mid-run) fall through to the
        scalar checks.  Its error is a `PlaneFault` and propagates: no
        vote of the run is counted.  Replaces the reference's per-vote
        verify at `types/vote_set.go:175` on the arrival path."""
        pre: set[int] = set()
        if len(run) >= self._microbatch_threshold():
            pre = self._batch_preverify([m.vote for m, _ in run])
        for c in range(0, len(run), self._VOTE_CHUNK_PER_LOCK):
            with self._mtx:
                for msg, peer_id in run[c:c + self._VOTE_CHUNK_PER_LOCK]:
                    if self.wal is not None and not self._replay_mode:
                        self.wal.save_message(M.encode_msg(msg))
                    try:
                        self._try_add_vote(msg.vote, peer_id,
                                           preverified=id(msg.vote) in pre)
                    except ErrVoteConflict as e:
                        self.evsw.fire("EvidenceDoubleSign", e.evidence)
                    except PlaneFault:
                        raise
                    except Exception:
                        log.exception("error handling vote at %d/%d",
                                      self.height, self.round)

    def _batch_preverify(self, votes: list) -> set[int]:
        """One grouped signature check on the plane (consensus class) for
        the current-height votes of a burst; returns the `id()`s of votes
        that verified.  Votes outside the current height/set (last-commit
        stragglers, future heights) are left to the scalar path — so a
        False here only means "not batched", never "rejected"."""
        vals = self.validators
        cached = getattr(self.plane.backend, "tables_cached", None)
        if cached is not None and not cached(vals.set_key()):
            # a COLD set would pay its comb-table build (K2) inside the
            # serialized loop (e.g. right after a validator-set change):
            # stay scalar until something else has built the tables
            return set()
        sel = []
        for v in votes:
            try:
                v.validate_basic()
            except ValueError:
                continue
            if (v.height == self.height and
                    0 <= v.validator_index < vals.size() and
                    vals.validators[v.validator_index].address ==
                    v.validator_address):
                sel.append(v)
        if len(sel) < self.VOTE_MICROBATCH_MIN:
            return set()
        ok = _on_plane(batch_verify_vote_sigs, self.state.chain_id, vals,
                       sel, self.plane)
        return {id(v) for v, good in zip(sel, ok) if good}

    def _on_timeout_fire(self, ti: TimeoutInfo) -> None:
        self._queue.put(ti)

    def _handle_msg(self, msg, peer_id: str) -> None:
        if isinstance(msg, M.ProposalMessage):
            self._set_proposal(msg.proposal)
        elif isinstance(msg, M.BlockPartMessage):
            self._add_proposal_block_part(msg.height, msg.part)
        elif isinstance(msg, M.VoteMessage):
            try:
                self._try_add_vote(msg.vote, peer_id)
            except ErrVoteConflict as e:
                # equivocation: evidence captured; byzantine peer
                self.evsw.fire("EvidenceDoubleSign", e.evidence)
        else:
            pass  # reactor-level messages are not for the core

    def _handle_timeout(self, ti: TimeoutInfo) -> None:
        """Reference `:664-701` handleTimeout."""
        if (ti.height, ti.round, ti.step) < (self.height, self.round,
                                             self.step):
            return
        if ti.step == STEP_NEW_HEIGHT:
            self._enter_new_round(ti.height, 0)
        elif ti.step == STEP_NEW_ROUND:
            # create_empty_blocks_interval expired while holding for txs
            self._enter_propose(ti.height, 0)
        elif ti.step == STEP_PROPOSE:
            self.evsw.fire(ev.TIMEOUT_PROPOSE, self._round_step_event())
            self._enter_prevote(ti.height, ti.round)
        elif ti.step == STEP_PREVOTE_WAIT:
            self.evsw.fire(ev.TIMEOUT_WAIT, self._round_step_event())
            self._enter_precommit(ti.height, ti.round)
        elif ti.step == STEP_PRECOMMIT_WAIT:
            self.evsw.fire(ev.TIMEOUT_WAIT, self._round_step_event())
            self._enter_new_round(ti.height, ti.round + 1)

    # ------------------------------------------------------------------
    # state update & round scheduling
    # ------------------------------------------------------------------
    def _update_to_state(self, state: State) -> None:
        """Prepare for the next height (reference `updateToState` :535-597)."""
        if (self.commit_round > -1 and 0 < self.height and
                self.height != state.last_block_height):
            raise RuntimeError("updateToState expected state at height "
                               f"{self.height}")
        # last precommits carry into the next proposal's commit
        last_precommits = None
        if self.commit_round > -1 and self.votes is not None:
            pc = self.votes.precommits(self.commit_round)
            if pc is None or not pc.has_two_thirds_majority():
                raise RuntimeError("expected +2/3 precommits for last commit")
            last_precommits = pc

        old_state = self.state
        self._app_hash_changed = (
            old_state.app_hash != state.app_hash
            if (old_state is not None and
                old_state.last_block_height + 1 == state.last_block_height)
            else None)
        height = state.last_block_height + 1
        self.height = height
        self.round = 0
        self.step = STEP_NEW_HEIGHT
        if self.commit_time:
            self.start_time = self.commit_time + self.cfg.timeout_commit
        else:
            self.start_time = time.time() + self.cfg.timeout_commit
        self.validators = state.validators.copy()
        self.proposal = None
        self.proposal_block = None
        self.proposal_block_parts = None
        self.locked_round = -1
        self.locked_block = None
        self.locked_block_parts = None
        self.votes = HeightVoteSet(state.chain_id, height, self.validators)
        self.commit_round = -1
        self.last_commit = last_precommits
        self.state = state

    def _schedule_round_0(self) -> None:
        sleep = max(0.0, self.start_time - time.time())
        self._ticker.schedule_timeout(TimeoutInfo(self.height, 0,
                                                  STEP_NEW_HEIGHT, sleep))

    def _new_step(self, step: int) -> None:
        self.step = step
        rs = self._round_step_event()
        self.evsw.fire(ev.NEW_ROUND_STEP, rs)
        self._broadcast(M.NewRoundStepMessage(
            height=rs.height, round=rs.round, step=rs.step,
            seconds_since_start=rs.seconds_since_start,
            last_commit_round=rs.last_commit_round))
        if step == STEP_COMMIT:
            self._broadcast_commit_step()

    def commit_step_message(self):
        """The current CommitStep advertisement, or None without a parts
        bitmap — the ONE place this message is assembled."""
        with self._mtx:
            if self.proposal_block_parts is None:
                return None
            return M.CommitStepMessage(
                height=self.height,
                parts_total=self.proposal_block_parts.total,
                parts_bits=tuple(self.proposal_block_parts.bit_array()))

    def _broadcast_commit_step(self) -> None:
        """Advertise the REAL parts bitmap while waiting in commit
        (reference sendNewRoundStepMessages also sends CommitStep), so a
        catchup sender re-sends what went missing."""
        msg = self.commit_step_message()
        if msg is not None:
            self._broadcast(msg)

    def _round_step_event(self) -> RoundStepEvent:
        lcr = self.last_commit.round if self.last_commit else -1
        # clamp: with skip_timeout_commit the new round starts before
        # start_time, and the u32 codec cannot carry a negative elapsed
        elapsed = max(0, int(time.time() - self.start_time))
        return RoundStepEvent(self.height, self.round, self.step,
                              elapsed, lcr)

    def _broadcast(self, msg) -> None:
        if self.broadcast_cb is not None and not self._replay_mode:
            self.broadcast_cb(msg)

    # ------------------------------------------------------------------
    # transitions (reference :755-1356)
    # ------------------------------------------------------------------
    def _enter_new_round(self, height: int, round_: int) -> None:
        if (height != self.height or round_ < self.round or
                (self.round == round_ and self.step != STEP_NEW_HEIGHT)):
            return
        if round_ > self.round:
            validators = self.validators.copy()
            validators.increment_accum(round_ - self.round)
            self.validators = validators
        self.round = round_
        self.step = STEP_NEW_ROUND
        if round_ != 0:
            # new round: drop the previous round's proposal
            self.proposal = None
            self.proposal_block = None
            self.proposal_block_parts = None
        self.votes.set_round(round_ + 1)
        self.evsw.fire(ev.NEW_ROUND, self._round_step_event())
        # wait-for-txs (reference :793-803): with create_empty_blocks off,
        # round 0 holds in NewRound until the mempool reports txs (unless
        # the app hash changed — a "proof block" must commit it); the
        # proposer signs heartbeats meanwhile so peers see it alive
        if (not self.cfg.create_empty_blocks and round_ == 0 and
                not self._need_proof_block(height)):
            # consult the pool directly: a txs-available marker that
            # fired during the commit was consumed at STEP_NEW_HEIGHT and
            # the mempool's once-per-height latch will not re-fire
            if getattr(self.mempool, "size", lambda: 0)() > 0:
                self._enter_propose(height, round_)
                return
            # advertise the hold, so peers gossip this height's material
            self._new_step(STEP_NEW_ROUND)
            if self.cfg.create_empty_blocks_interval > 0:
                self._ticker.schedule_timeout(TimeoutInfo(
                    height, round_, STEP_NEW_ROUND,
                    self.cfg.create_empty_blocks_interval))
            self._start_heartbeat(height, round_)
            return
        self._enter_propose(height, round_)

    def _need_proof_block(self, height: int) -> bool:
        """First height, or the last block changed the app hash
        (reference `needProofBlock` :807-818); tracked per height in
        `_update_to_state`, the store read only cold after a restart."""
        if height == 1:
            return True
        if self._app_hash_changed is not None:
            return self._app_hash_changed
        last = self.block_store.load_block(height - 1)
        # last block's header carries the app hash BEFORE its execution;
        # if the live app hash differs, that block changed it
        return last is None or self.state.app_hash != last.header.app_hash

    def _handle_txs_available(self, item: _TxsAvailable) -> None:
        """Mempool has txs: leave the NewRound hold (reference
        `handleTxsAvailable` — enterPropose for the current round)."""
        if item.height != self.height or self.step != STEP_NEW_ROUND:
            return
        self._enter_propose(self.height, self.round)

    def _start_heartbeat(self, height: int, round_: int) -> None:
        """Sign + gossip ProposalHeartbeat every 2s while holding in
        NewRound (reference `proposalHeartbeat` :820-847)."""
        if self.priv_validator is None or self._replay_mode:
            return

        def run():
            seq = 0
            addr = self.priv_validator.address
            idx = self.validators.index_of(addr)
            while not self._stopped.is_set():
                with self._mtx:
                    if (self.height != height or self.round > round_ or
                            self.step > STEP_NEW_ROUND):
                        return
                    chain_id = self.state.chain_id
                hb = Heartbeat(validator_address=addr, validator_index=idx,
                               height=height, round=round_, sequence=seq)
                sig = self.priv_validator.sign_heartbeat(chain_id, hb)
                hb = Heartbeat(validator_address=addr, validator_index=idx,
                               height=height, round=round_, sequence=seq,
                               signature=sig)
                self.evsw.fire(ev.PROPOSAL_HEARTBEAT, hb)
                self._broadcast(M.ProposalHeartbeatMessage(hb))
                seq += 1
                if self._stopped.wait(PROPOSAL_HEARTBEAT_INTERVAL):
                    return

        threading.Thread(target=run, daemon=True,
                         name=f"heartbeat-{height}").start()

    def _enter_propose(self, height: int, round_: int) -> None:
        if (height != self.height or round_ < self.round or
                (self.round == round_ and self.step >= STEP_PROPOSE)):
            return
        self.round = round_
        self._new_step(STEP_PROPOSE)
        self._ticker.schedule_timeout(TimeoutInfo(
            height, round_, STEP_PROPOSE, self.cfg.propose_timeout(round_)))
        if self.is_proposer():
            self._decide_proposal(height, round_)
        if self._is_proposal_complete():
            self._enter_prevote(height, round_)

    def _decide_proposal(self, height: int, round_: int) -> None:
        """Reference `:899-981` defaultDecideProposal/createProposalBlock."""
        if self.locked_block is not None:
            block, parts = self.locked_block, self.locked_block_parts
        else:
            block, parts = self._create_proposal_block()
            if block is None:
                return
        # POL metadata comes as a pair from POLInfo — round and block id of
        # the newest prevote polka together (reference :905-907)
        pol = self.votes.pol_info()
        pol_round, pol_block_id = pol if pol is not None else (-1, None)
        proposal = Proposal(height=height, round=round_,
                            block_parts_header=parts.header,
                            pol_round=pol_round, pol_block_id=pol_block_id)
        try:
            sig = self.priv_validator.sign_proposal(self.state.chain_id,
                                                    proposal)
        except DoubleSignError:
            return
        proposal = Proposal(**{**proposal.__dict__, "signature": sig})
        # loop own messages through the queue (determinism + WAL), and hand
        # them to the gossip layer
        self._queue.put((M.ProposalMessage(proposal), ""))
        self._broadcast(M.ProposalMessage(proposal))
        for i in range(parts.total):
            msg = M.BlockPartMessage(height, round_, parts.get_part(i))
            self._queue.put((msg, ""))
            self._broadcast(msg)

    def _create_proposal_block(self):
        """Reference `createProposalBlock` `:961-981`."""
        if self.height == 1:
            commit = EMPTY_COMMIT
        elif self.last_commit is not None and \
                self.last_commit.has_two_thirds_majority():
            commit = self.last_commit.make_commit()
        else:
            return None, None   # don't have the commit yet
        txs = self.mempool.reap(self.cfg.max_block_size_txs)
        block = Block.make(
            chain_id=self.state.chain_id, height=self.height,
            time_ns=time.time_ns(), txs=txs, last_commit=commit,
            last_block_id=self.state.last_block_id,
            validators_hash=self.state.validators.hash(),
            app_hash=self.state.app_hash)
        return block, block.make_part_set()

    def _is_proposal_complete(self) -> bool:
        if self.proposal is None or self.proposal_block is None:
            return False
        if self.proposal.pol_round < 0:
            return True
        pv = self.votes.prevotes(self.proposal.pol_round)
        return pv is not None and pv.has_two_thirds_majority()

    def _enter_prevote(self, height: int, round_: int) -> None:
        if (height != self.height or round_ < self.round or
                (self.round == round_ and self.step >= STEP_PREVOTE)):
            return
        self.round = round_
        self._do_prevote(height, round_)
        self._new_step(STEP_PREVOTE)

    def _do_prevote(self, height: int, round_: int) -> None:
        """Reference `defaultDoPrevote` `:1015-1047`."""
        if self.locked_block is not None:
            self._sign_add_vote(TYPE_PREVOTE,
                                self._locked_block_id())
            return
        if self.proposal_block is None:
            self._sign_add_vote(TYPE_PREVOTE, ZERO_BLOCK_ID)
            return
        try:
            execution.validate_block(self.state, self.proposal_block,
                                     self._commit_verifier)
        except ValueError:
            self._sign_add_vote(TYPE_PREVOTE, ZERO_BLOCK_ID)
            return
        self._sign_add_vote(TYPE_PREVOTE, BlockID(
            self.proposal_block.hash(), self.proposal_block_parts.header))

    def _enter_prevote_wait(self, height: int, round_: int) -> None:
        if (height != self.height or round_ < self.round or
                (self.round == round_ and self.step >= STEP_PREVOTE_WAIT)):
            return
        self.round = round_
        self._new_step(STEP_PREVOTE_WAIT)
        self._ticker.schedule_timeout(TimeoutInfo(
            height, round_, STEP_PREVOTE_WAIT,
            self.cfg.prevote_timeout(round_)))

    def _enter_precommit(self, height: int, round_: int) -> None:
        """Lock/unlock rules (reference `:1076-1184`)."""
        if (height != self.height or round_ < self.round or
                (self.round == round_ and self.step >= STEP_PRECOMMIT)):
            return
        self.round = round_
        self._new_step(STEP_PRECOMMIT)
        maj = self.votes.prevotes(round_).two_thirds_majority() \
            if self.votes.prevotes(round_) else None
        if maj is None:
            # no polka: precommit nil, keep any lock
            self._sign_add_vote(TYPE_PRECOMMIT, ZERO_BLOCK_ID)
            return
        self.evsw.fire(ev.POLKA, self._round_step_event())
        if maj.is_zero():
            # +2/3 prevoted nil: unlock (reference :1112-1121)
            if self.locked_block is not None:
                self.locked_round = -1
                self.locked_block = None
                self.locked_block_parts = None
                self.evsw.fire(ev.UNLOCK, self._round_step_event())
            self._sign_add_vote(TYPE_PRECOMMIT, ZERO_BLOCK_ID)
            return
        if (self.locked_block is not None and
                self.locked_block.hash() == maj.hash):
            # relock on the same block at a later round
            self.locked_round = round_
            self.evsw.fire(ev.RELOCK, self._round_step_event())
            self._sign_add_vote(TYPE_PRECOMMIT, maj)
            return
        if (self.proposal_block is not None and
                self.proposal_block.hash() == maj.hash):
            try:
                execution.validate_block(self.state, self.proposal_block,
                                         self._commit_verifier)
            except ValueError:
                # polka for an invalid block!?  precommit nil
                self._sign_add_vote(TYPE_PRECOMMIT, ZERO_BLOCK_ID)
                return
            self.locked_round = round_
            self.locked_block = self.proposal_block
            self.locked_block_parts = self.proposal_block_parts
            self.evsw.fire(ev.LOCK, self._round_step_event())
            self._sign_add_vote(TYPE_PRECOMMIT, maj)
            return
        # polka for a block we don't have: unlock and fetch it
        self.locked_round = -1
        self.locked_block = None
        self.locked_block_parts = None
        if (self.proposal_block_parts is None or
                self.proposal_block_parts.header.hash != maj.parts.hash):
            self.proposal_block = None
            self.proposal_block_parts = PartSet(maj.parts)
        self.evsw.fire(ev.UNLOCK, self._round_step_event())
        self._sign_add_vote(TYPE_PRECOMMIT, ZERO_BLOCK_ID)

    def _enter_precommit_wait(self, height: int, round_: int) -> None:
        if (height != self.height or round_ < self.round or
                (self.round == round_ and self.step >= STEP_PRECOMMIT_WAIT)):
            return
        self.round = round_
        self._new_step(STEP_PRECOMMIT_WAIT)
        self._ticker.schedule_timeout(TimeoutInfo(
            height, round_, STEP_PRECOMMIT_WAIT,
            self.cfg.precommit_timeout(round_)))

    def _enter_commit(self, height: int, commit_round: int) -> None:
        """Reference `:1191-1252`."""
        if height != self.height or self.step >= STEP_COMMIT:
            return
        self.commit_round = commit_round
        self.commit_time = time.time()
        self._new_step(STEP_COMMIT)
        maj = self.votes.precommits(commit_round).two_thirds_majority()
        assert maj is not None and not maj.is_zero()
        # promote locked block if it is the committed one
        if (self.locked_block is not None and
                self.locked_block.hash() == maj.hash):
            self.proposal_block = self.locked_block
            self.proposal_block_parts = self.locked_block_parts
        if (self.proposal_block is None or
                self.proposal_block.hash() != maj.hash):
            if (self.proposal_block_parts is None or
                    self.proposal_block_parts.header.hash != maj.parts.hash):
                # wait for the parts to arrive — and TELL peers what we
                # hold: _new_step above broadcast before this PartSet
                # existed, so its CommitStep was skipped
                self.proposal_block = None
                self.proposal_block_parts = PartSet(maj.parts)
                self._broadcast_commit_step()
            return
        self._try_finalize_commit(height)

    def _try_finalize_commit(self, height: int) -> None:
        maj = self.votes.precommits(self.commit_round).two_thirds_majority()
        if maj is None or maj.is_zero():
            return
        if (self.proposal_block is None or
                self.proposal_block.hash() != maj.hash):
            return
        self._finalize_commit(height)

    def _finalize_commit(self, height: int) -> None:
        """Reference `finalizeCommit` `:1259-1356`."""
        if self.step != STEP_COMMIT:
            return
        block, parts = self.proposal_block, self.proposal_block_parts
        maj = self.votes.precommits(self.commit_round).two_thirds_majority()
        if parts.header != maj.parts:
            raise RuntimeError("finalize: parts header != +2/3 block id")
        execution.validate_block(self.state, block, self._commit_verifier)
        if self.block_store.height < block.height:
            seen_commit = self.votes.precommits(
                self.commit_round).make_commit()
            self.block_store.save_block(block, parts, seen_commit)
        if self.wal is not None and not self._replay_mode:
            self.wal.write_end_height(height)

        state_copy = self.state.copy()
        event_cache = EventCache(self.evsw)
        execution.apply_block(state_copy, self.proxy, block, parts.header,
                              self.mempool, self._commit_verifier,
                              event_cache=event_cache,
                              tx_indexer=self.tx_indexer)
        event_cache.fire(ev.NEW_BLOCK, block)
        event_cache.fire(ev.NEW_BLOCK_HEADER, block.header)
        log.info("committed block %d (%d txs)", block.height,
                 len(block.txs))
        self._update_to_state(state_copy)
        event_cache.flush()
        self._schedule_round_0()

    # ------------------------------------------------------------------
    # proposal / parts / votes ingestion (reference :1363-1565)
    # ------------------------------------------------------------------
    def _set_proposal(self, proposal: Proposal) -> None:
        if self.proposal is not None:
            return
        if proposal.height != self.height or proposal.round != self.round:
            return
        if not (-1 <= proposal.pol_round < proposal.round):
            return
        ok = self.validators.proposer.pub_key.verify(
            proposal.sign_bytes(self.state.chain_id), proposal.signature)
        if not ok:
            raise ValueError("invalid proposal signature")
        self.proposal = proposal
        if (self.proposal_block_parts is None or
                self.proposal_block_parts.header.hash !=
                proposal.block_parts_header.hash):
            self.proposal_block_parts = PartSet(proposal.block_parts_header)

    def _add_proposal_block_part(self, height: int, part) -> None:
        if height != self.height or self.proposal_block_parts is None:
            return
        added = self.proposal_block_parts.add_part(part)
        if not added:
            return
        if self.proposal_block_parts.is_complete():
            data = self.proposal_block_parts.assemble()
            try:
                self.proposal_block = Block.decode_bytes(data)
            except ValueError:
                # proof-valid parts that assemble to an undecodable block
                # mean the PRODUCER built garbage (Byzantine): loud, since
                # a complete partset stops every re-send
                log.error("complete proposal parts failed to decode at "
                          "height %d (parts %s)", height,
                          self.proposal_block_parts.header.hash.hex()[:12])
                self.proposal_block = None
                return
            self.evsw.fire(ev.COMPLETE_PROPOSAL, self._round_step_event())
            if self.step <= STEP_PROPOSE and self._is_proposal_complete():
                self._enter_prevote(height, self.round)
            elif self.step == STEP_COMMIT:
                self._try_finalize_commit(height)
        elif self.step == STEP_COMMIT:
            # still waiting in commit: keep peers' models of our parts
            # honest (time-throttled: a 300-part block must not emit 300
            # full-bitmap broadcasts)
            now = time.time()
            if now - self._commit_step_bcast >= 0.2:
                self._commit_step_bcast = now
                self._broadcast_commit_step()

    def _try_add_vote(self, vote: Vote, peer_id: str,
                      preverified: bool = False) -> None:
        """Reference `tryAddVote`/`addVote` `:1430-1565`.
        `preverified` marks a signature already checked by the receive
        loop's grouped micro-batch (`_batch_preverify`)."""
        # LastCommit vote for the previous height (reference :1466-1491)
        if vote.height + 1 == self.height:
            if not (self.step == STEP_NEW_HEIGHT and
                    vote.type == TYPE_PRECOMMIT and
                    self.last_commit is not None):
                return
            if self.last_commit.add_vote(vote):
                self._broadcast(M.HasVoteMessage(
                    vote.height, vote.round, vote.type,
                    vote.validator_index))
                # straggler completed the last commit: skip timeout_commit
                # (reference :1475-1480)
                if self.cfg.skip_timeout_commit and \
                        self.last_commit.has_all():
                    self._enter_new_round(self.height, 0)
            return
        if vote.height != self.height:
            return
        added = self.votes.add_vote(vote, peer_id, verify=not preverified)
        if not added:
            return
        self.evsw.fire(ev.VOTE, vote)
        self._broadcast(M.HasVoteMessage(vote.height, vote.round, vote.type,
                                         vote.validator_index))
        height, round_ = self.height, vote.round
        if vote.type == TYPE_PREVOTE:
            prevotes = self.votes.prevotes(round_)
            maj = prevotes.two_thirds_majority()
            # unlock on a valid POL: lockRound < POLRound <= current round
            # (reference :1497-1512 — a nil polka also unlocks)
            if maj is not None and self.locked_block is not None and \
                    self.locked_round < round_ <= self.round and \
                    self.locked_block.hash() != maj.hash:
                self.locked_round = -1
                self.locked_block = None
                self.locked_block_parts = None
                self.evsw.fire(ev.UNLOCK, self._round_step_event())
            if self.round <= round_ and prevotes.has_two_thirds_any():
                # round-skip to PrevoteWait or straight to Precommit
                # (reference :1513-1522)
                self._enter_new_round(height, round_)
                if maj is not None:
                    self._enter_precommit(height, round_)
                else:
                    self._enter_prevote(height, round_)
                    self._enter_prevote_wait(height, round_)
            elif (self.proposal is not None and
                  0 <= self.proposal.pol_round == round_):
                if self._is_proposal_complete():
                    self._enter_prevote(height, self.round)
        else:  # precommit (reference :1528-1554)
            precommits = self.votes.precommits(round_)
            maj = precommits.two_thirds_majority()
            if maj is not None:
                if maj.is_zero():
                    # nil majority: the round is dead, move on immediately
                    self._enter_new_round(height, round_ + 1)
                else:
                    self._enter_new_round(height, round_)
                    self._enter_precommit(height, round_)
                    self._enter_commit(height, round_)
                    if self.cfg.skip_timeout_commit and \
                            precommits.has_all():
                        self._enter_new_round(self.height, 0)
            elif self.round <= round_ and precommits.has_two_thirds_any():
                self._enter_new_round(height, round_)
                self._enter_precommit(height, round_)
                self._enter_precommit_wait(height, round_)

    def _locked_block_id(self) -> BlockID:
        return BlockID(self.locked_block.hash(),
                       self.locked_block_parts.header)

    def _sign_add_vote(self, type_: int, block_id: BlockID) -> None:
        """Reference `signAddVote` `:1567-1599`."""
        if self.priv_validator is None or \
                not self.validators.has_address(self.priv_validator.address):
            return
        idx = self.validators.index_of(self.priv_validator.address)
        vote = Vote(validator_address=self.priv_validator.address,
                    validator_index=idx, height=self.height,
                    round=self.round, type=type_, block_id=block_id)
        try:
            sig = self.priv_validator.sign_vote(self.state.chain_id, vote)
        except DoubleSignError as e:
            # reference signAddVote logs the refusal and returns (:1593): a
            # validator restarted behind its own sign watermark keeps
            # following the net without voting until it passes it
            if not self._replay_mode:
                log.warning("vote signing refused at %d/%d step %d: %s",
                            self.height, self.round, self.step, e)
            return
        vote = Vote(**{**vote.__dict__, "signature": sig})
        # loop back through the queue; also hand to the gossip layer
        self._queue.put((M.VoteMessage(vote), ""))
        self._broadcast(M.VoteMessage(vote))

    # ------------------------------------------------------------------
    # WAL catchup replay (reference consensus/replay.go:97-169)
    # ------------------------------------------------------------------
    def _catchup_replay(self) -> None:
        height = self.height
        recs = WAL.records_since_height(self.wal.path, height)
        if recs is None:
            raise RuntimeError(
                f"WAL should not contain #ENDHEIGHT {height}")
        if not recs:
            # marker for height-1 missing: either a fresh WAL, or the crash
            # hit the finalize window between save_block and
            # write_end_height and the handshake already advanced state.
            # Back-fill the marker so future restarts replay correctly.
            self.wal.write_end_height(height - 1)
            return
        self._replay_mode = True
        try:
            for kind, payload in recs:
                # live mode survives bad peer input (the receive loop
                # catches); replay must be equally tolerant or one invalid
                # persisted message crash-loops every restart
                try:
                    if kind == REC_MESSAGE:
                        self._handle_msg(M.decode_msg(payload), "")
                    elif kind == REC_TIMEOUT:
                        h, r, s = struct.unpack(">QIB", payload)
                        self._handle_timeout(TimeoutInfo(h, r, s))
                except PlaneFault:
                    raise
                except Exception:
                    log.exception("error replaying WAL record")
        finally:
            self._replay_mode = False
