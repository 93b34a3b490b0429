"""Consensus gossip reactor: parts/votes/maj23 dissemination over p2p.

Reference: `consensus/reactor.go` (1353 LoC) — four p2p channels (State
0x20, Data 0x21, Vote 0x22, VoteSetBits 0x23, `:20-27,93-120`); per-peer
gossip routines spawned in `AddPeer` (`:123-142`): `gossipDataRoutine`
(`:413`) pushes proposals/POL/block parts the peer is missing,
`gossipVotesRoutine` (`:537`) pushes votes chosen against the peer's
bit-arrays, `queryMaj23Routine` (`:647`) advertises two-thirds
majorities; `Receive` demuxes inbound (`:159-302`); `PeerState` mirrors
each peer's round progress (`:757-1168`).

Copy of `tendermint_tpu/consensus/reactor.py`.  Votes and proposals
travel in the JAX reactor's `StampedMessage` envelope, stamped with the
sender's `tracing.now_epoch()` and its consensus state's `node_id`; the
receiver observes the gossip fan-out lag (`gossip_fanout_seconds`).  No
fallback: the JAX gossip routines
log any error and carry on; here an error ends the routine, stays on the
reactor as `fault`, and `stop()` raises it, as it raises the core's
plane fault (`ConsensusState.stop`).  A peer's claims are bounded before
a bitmap is allocated for them: a proposal of more than `MAX_BLOCK_PARTS`
parts drops the peer (the JAX reactor allocates the bitmap first, and
dies of it), and the vote bit-arrays a peer's `VoteSetBitsMessage`
creates take the validator count, as the reference's
`EnsureVoteBitArrays` does, not the message's length.
"""

from __future__ import annotations

import random
import threading
import time

from tendermint_tpu_torch.consensus import messages as M
from tendermint_tpu_torch.consensus.state import (STEP_COMMIT,
                                                  STEP_NEW_HEIGHT,
                                                  STEP_PRECOMMIT_WAIT,
                                                  STEP_PREVOTE)
from tendermint_tpu_torch.p2p.peer import Peer, Reactor
from tendermint_tpu_torch.p2p.types import ChannelDescriptor
from tendermint_tpu_torch.types import TYPE_PRECOMMIT, TYPE_PREVOTE
from tendermint_tpu_torch.types.part_set import PART_SIZE
from tendermint_tpu_torch.utils import tracing
from tendermint_tpu_torch.utils.fmt import bits_str
from tendermint_tpu_torch.utils.log import DEBUG, get_logger
from tendermint_tpu_torch.utils.metrics import REGISTRY

log = get_logger("cons-rx")

STATE_CHANNEL = 0x20
DATA_CHANNEL = 0x21
VOTE_CHANNEL = 0x22
VOTE_SET_BITS_CHANNEL = 0x23

# the reference's largest block (`MaxBlockSize`, 22,020,096 bytes) in
# 64 KB parts (`types/block.go:18-19`)
MAX_BLOCK_PARTS = 22_020_096 // PART_SIZE

GOSSIP_SLEEP = 0.1           # IDLE-ONLY safety net; gossip is event-driven
                             # (reference peerGossipSleepDuration 100ms, but
                             # the reference POLLS at that cadence — here a
                             # condition variable wakes the routines the
                             # moment core or peer state changes, so the
                             # sleep only bounds staleness after a missed
                             # signal; VERDICT r3: 20ms polling across
                             # N peers x 3 threads starved the GIL)
MAJ23_SLEEP = 0.5            # reference peerQueryMaj23SleepDuration (2s)


class PeerRoundState:
    """Mirror of one peer's consensus progress
    (reference `consensus/reactor.go:1068+` PeerRoundState)."""

    def __init__(self):
        self.height = 0
        self.round = -1
        self.step = 0
        self.proposal = False
        self.proposal_block_parts_header = None
        self.proposal_block_parts: list[bool] | None = None
        self.proposal_pol_round = -1
        self.proposal_pol: list[bool] | None = None
        self.prevotes: dict[int, list[bool]] = {}       # round -> bits
        self.precommits: dict[int, list[bool]] = {}
        self.last_commit_round = -1
        self.last_commit: list[bool] | None = None
        self.catchup_commit_round = -1
        self.catchup_commit: list[bool] | None = None


class PeerState:
    """Thread-safe wrapper around PeerRoundState
    (reference `consensus/reactor.go:757-1168`)."""

    def __init__(self, peer: Peer):
        self.peer = peer
        self.prs = PeerRoundState()
        self._lock = threading.RLock()

    def summary(self) -> dict:
        """Peer round state for dump_consensus_state (reference dumps
        PeerRoundStates alongside the RoundState, `rpc/core/routes.go:21`)."""
        with self._lock:
            prs = self.prs
            return {
                "height": prs.height, "round": prs.round, "step": prs.step,
                "proposal": prs.proposal,
                "proposal_block_parts": bits_str(prs.proposal_block_parts),
                "proposal_pol_round": prs.proposal_pol_round,
                "proposal_pol": bits_str(prs.proposal_pol),
                "prevotes": {r: bits_str(b) for r, b in prs.prevotes.items()},
                "precommits": {r: bits_str(b)
                               for r, b in prs.precommits.items()},
                "last_commit_round": prs.last_commit_round,
                "last_commit": bits_str(prs.last_commit),
                "catchup_commit_round": prs.catchup_commit_round,
                "catchup_commit": bits_str(prs.catchup_commit),
            }

    # -- applying peer messages ----------------------------------------
    def apply_new_round_step(self, msg: M.NewRoundStepMessage) -> None:
        with self._lock:
            prs = self.prs
            ph, pr = prs.height, prs.round
            prs.height, prs.round, prs.step = msg.height, msg.round, msg.step
            if ph != msg.height or pr != msg.round:
                prs.proposal = False
                prs.proposal_block_parts_header = None
                prs.proposal_block_parts = None
                prs.proposal_pol_round = -1
                prs.proposal_pol = None
            if ph == msg.height and pr != msg.round and \
                    msg.round == prs.catchup_commit_round:
                prs.precommits[msg.round] = prs.catchup_commit or []
            if ph != msg.height:
                # peer advanced: its current-round precommits become the
                # last-commit view (reference :1232-1245)
                if ph + 1 == msg.height and pr == msg.last_commit_round:
                    prs.last_commit_round = msg.last_commit_round
                    prs.last_commit = prs.precommits.get(pr)
                else:
                    prs.last_commit_round = msg.last_commit_round
                    prs.last_commit = None
                prs.prevotes.clear()
                prs.precommits.clear()
                prs.catchup_commit_round = -1
                prs.catchup_commit = None

    def apply_commit_step(self, msg: M.CommitStepMessage) -> None:
        with self._lock:
            if self.prs.height != msg.height:
                return
            if (self.prs.proposal_block_parts is None or
                    len(msg.parts_bits) == len(self.prs.proposal_block_parts)):
                # the peer's own bitmap is ground truth; also (re)creates
                # the model after a round-change reset so catchup data
                # gossip resumes from what the peer actually holds
                self.prs.proposal_block_parts = list(msg.parts_bits)

    def set_has_proposal(self, proposal) -> None:
        with self._lock:
            prs = self.prs
            if prs.height != proposal.height or prs.round != proposal.round \
                    or prs.proposal:
                return
            prs.proposal = True
            prs.proposal_block_parts_header = proposal.block_parts_header
            if prs.proposal_block_parts is None:
                prs.proposal_block_parts = \
                    [False] * proposal.block_parts_header.total
            prs.proposal_pol_round = proposal.pol_round
            prs.proposal_pol = None

    def init_proposal_block_parts(self, header) -> None:
        """Sender-side (re)init for catchup gossip.  Reference
        `gossipDataRoutine` reactor.go:505-510 only LOGS the header
        mismatch ("peer ProposalBlockPartsHeader mismatch") and sleeps
        for the next tick — it never re-keys the peer's bitmap.  We
        deliberately diverge and RESET the bitmap to the stored block's
        header; the divergence is covered by the stress tier.

        The reset matters: a peer that proposed its OWN block for a
        later round advertises that proposal, so our model's bitmap
        refers to the peer's round-R partset — using it as the bitmap
        for the COMMITTED block marks parts delivered that the peer
        never got, and catchup never re-sends them (the [25,25,0,25]
        wedge caught by the stress tier's state dump)."""
        with self._lock:
            if (self.prs.proposal_block_parts is None or
                    self.prs.proposal_block_parts_header != header):
                self.prs.proposal_block_parts_header = header
                self.prs.proposal_block_parts = [False] * header.total

    def set_has_part(self, height: int, index: int) -> None:
        with self._lock:
            prs = self.prs
            if prs.height != height or prs.proposal_block_parts is None:
                return
            if 0 <= index < len(prs.proposal_block_parts):
                prs.proposal_block_parts[index] = True

    def apply_proposal_pol(self, msg: M.ProposalPOLMessage) -> None:
        with self._lock:
            prs = self.prs
            if prs.height != msg.height or \
                    prs.proposal_pol_round != msg.proposal_pol_round:
                return
            prs.proposal_pol = list(msg.proposal_pol)

    def _bits_for(self, height: int, round_: int, type_: int,
                  n: int | None = None) -> list[bool] | None:
        """The peer's vote bit-array for (height, round, type), creating it
        when `n` (validator count) is given (reference getVoteBitArray)."""
        prs = self.prs
        if height == prs.height:
            d = prs.prevotes if type_ == TYPE_PREVOTE else prs.precommits
            bits = d.get(round_)
            if bits is None and n is not None:
                bits = d[round_] = [False] * n
            if bits is None and type_ == TYPE_PRECOMMIT and \
                    round_ == prs.catchup_commit_round:
                return prs.catchup_commit
            return bits
        if height + 1 == prs.height and type_ == TYPE_PRECOMMIT and \
                round_ == prs.last_commit_round:
            if prs.last_commit is None and n is not None:
                prs.last_commit = [False] * n
            return prs.last_commit
        if height < prs.height - 1 and type_ == TYPE_PRECOMMIT:
            return None
        return None

    def ensure_catchup_commit(self, height: int, round_: int, n: int) -> None:
        with self._lock:
            prs = self.prs
            if prs.height == height and prs.catchup_commit_round != round_:
                prs.catchup_commit_round = round_
                prs.catchup_commit = [False] * n

    def set_has_vote(self, height: int, round_: int, type_: int,
                     index: int, n: int | None = None) -> None:
        with self._lock:
            prs = self.prs
            if height == prs.height and prs.catchup_commit_round == round_ \
                    and type_ == TYPE_PRECOMMIT and \
                    prs.catchup_commit is not None and \
                    index < len(prs.catchup_commit):
                prs.catchup_commit[index] = True
            bits = self._bits_for(height, round_, type_, n)
            if bits is not None and 0 <= index < len(bits):
                bits[index] = True

    def apply_vote_set_bits(self, msg: M.VoteSetBitsMessage,
                            our_bits: list[bool] | None,
                            n: int | None) -> None:
        """Merge a peer's claimed vote bits.  When the claim is for a
        specific block we AND with our own view per the reference's
        sub-set semantics (`ApplyVoteSetBitsMessage`).  A missing
        bit-array is created with `n` bits (the validator count; none
        when None), never with the message's length."""
        with self._lock:
            bits = self._bits_for(msg.height, msg.round, msg.type, n)
            if bits is None:
                return
            for i, b in enumerate(msg.votes_bits):
                if i < len(bits) and b:
                    bits[i] = True

    def pick_missing(self, ours: list[bool],
                     theirs: list[bool] | None) -> int | None:
        """Random index we have and the peer lacks."""
        with self._lock:
            if theirs is None:
                theirs = []
            cands = [i for i, o in enumerate(ours)
                     if o and (i >= len(theirs) or not theirs[i])]
        return random.choice(cands) if cands else None


class ConsensusReactor(Reactor):
    """Reference `consensus/reactor.go:38-302`."""

    def __init__(self, consensus_state, fast_sync: bool = False,
                 gossip_sleep: float = GOSSIP_SLEEP):
        super().__init__()
        self.cs = consensus_state
        self.fast_sync = fast_sync
        self.gossip_sleep = gossip_sleep
        self._peer_stops: dict[str, threading.Event] = {}
        self._lock = threading.Lock()
        # event-driven gossip: every core broadcast and every applied peer
        # message bumps the sequence and wakes all gossip routines; idle
        # routines block here instead of busy-polling
        self._wake = threading.Condition()
        self._wake_seq = 0
        # the error that ended a gossip routine (`stop` raises it)
        self.fault: BaseException | None = None
        # core -> network: NewRoundStep/HasVote broadcasts
        # (reference `registerEventCallbacks` :321-382)
        self.cs.broadcast_cb = self._on_core_broadcast

    def _notify_work(self) -> None:
        with self._wake:
            self._wake_seq += 1
            self._wake.notify_all()

    def _wait_work(self, seen_seq: int, timeout: float) -> None:
        """Block until the work sequence moves past seen_seq or timeout."""
        with self._wake:
            if self._wake_seq == seen_seq:
                self._wake.wait(timeout)

    def get_channels(self):
        return [
            ChannelDescriptor(id=STATE_CHANNEL, priority=5,
                              send_queue_capacity=100),
            ChannelDescriptor(id=DATA_CHANNEL, priority=10,
                              send_queue_capacity=100),
            ChannelDescriptor(id=VOTE_CHANNEL, priority=5,
                              send_queue_capacity=100),
            ChannelDescriptor(id=VOTE_SET_BITS_CHANNEL, priority=1,
                              send_queue_capacity=2),
        ]

    def start(self) -> None:
        if not self.fast_sync:
            self.cs.start()

    def stop(self) -> None:
        """Stop the gossip routines and the core; raise the core's plane
        fault, else the fault that ended a gossip routine."""
        with self._lock:
            for ev in self._peer_stops.values():
                ev.set()
        self._notify_work()
        self.cs.stop()
        if self.fault is not None:
            raise self.fault

    def _routine(self, fn, peer: Peer, ps: "PeerState",
                 stop: threading.Event) -> None:
        """Run one gossip routine; an error ends it and is kept."""
        try:
            fn(peer, ps, stop)
        except BaseException as e:
            log.error("gossip stopped by a fault", peer=peer.id[:8],
                      error=repr(e))
            with self._lock:
                if self.fault is None:
                    self.fault = e

    def switch_to_consensus(self, state) -> None:
        """Fast-sync is caught up: boot the live state machine
        (reference `SwitchToConsensus` :78-90).  The flag turns off once
        the state is the synced one and its last commit rebuilt, as in
        the reference: whoever sees `fast_sync` off (the receive path,
        a reader of the node's status) sees the consensus height that
        goes with it.  The JAX package turns it off first."""
        self.cs._update_to_state(state)
        self.cs._reconstruct_last_commit(state)
        self.fast_sync = False
        self.cs.start()

    # -- core -> network -----------------------------------------------
    def _on_core_broadcast(self, msg) -> None:
        if isinstance(msg, (M.NewRoundStepMessage, M.HasVoteMessage,
                            M.CommitStepMessage,
                            M.ProposalHeartbeatMessage)):
            if self.switch is not None:
                self.switch.broadcast(STATE_CHANNEL, M.encode_msg(msg))
        # proposals/parts/votes flow through the per-peer gossip routines —
        # wake them: the core's state just changed
        self._notify_work()

    # -- peer lifecycle -------------------------------------------------
    def add_peer(self, peer: Peer) -> None:
        ps = PeerState(peer)
        peer.set("consensus", ps)
        stop = threading.Event()
        with self._lock:
            self._peer_stops[peer.id] = stop
        for fn, name in ((self._gossip_data_routine, "gossip-data"),
                         (self._gossip_votes_routine, "gossip-votes"),
                         (self._query_maj23_routine, "query-maj23")):
            threading.Thread(target=self._routine, args=(fn, peer, ps, stop),
                             daemon=True,
                             name=f"{name}-{peer.id[:8]}").start()
        # tell the new peer where we are
        rs = self.cs.get_round_state()
        lcr = rs.last_commit.round if rs.last_commit else -1
        peer.try_send(STATE_CHANNEL, M.encode_msg(M.NewRoundStepMessage(
            height=rs.height, round=rs.round, step=rs.step,
            seconds_since_start=max(0, int(time.time() - rs.start_time)),
            last_commit_round=lcr)))

    def remove_peer(self, peer: Peer, reason) -> None:
        with self._lock:
            stop = self._peer_stops.pop(peer.id, None)
        if stop is not None:
            stop.set()
        self._notify_work()   # unblock its waiting gossip routines

    def _stamp(self, msg) -> bytes:
        """Encode a vote/proposal for the wire inside a send-time-stamped
        envelope (timeline plane): the receiver's unwrap measures this
        link's gossip fan-out lag.  State/bulk-data messages stay bare."""
        return M.encode_msg(M.StampedMessage(
            msg, sent_ts=tracing.now_epoch(), origin=self.cs.node_id))

    # -- inbound demux (reference :159-302) ------------------------------
    def receive(self, ch_id: int, peer: Peer, raw: bytes) -> None:
        try:
            msg = M.decode_msg(raw)
        except (ValueError, IndexError) as e:
            self.switch.stop_peer_for_error(peer, f"bad consensus msg: {e}")
            return
        if isinstance(msg, M.StampedMessage):
            if msg.sent_ts > 0.0:
                # cross-host clocks skew: a negative lag is a clock
                # artifact, clamp rather than poison the histogram
                REGISTRY.gossip_fanout_seconds.observe(
                    max(0.0, tracing.now_epoch() - msg.sent_ts))
            msg = msg.msg
        ps: PeerState = peer.get("consensus")
        if ps is None:
            return
        try:
            self._receive(ch_id, peer, ps, msg)
        finally:
            # applied peer state (or fed the core): gossip routines may
            # now have sendable work for this peer — wake them
            self._notify_work()

    def _receive(self, ch_id: int, peer: Peer, ps: "PeerState", msg) -> None:
        if ch_id == STATE_CHANNEL:
            if isinstance(msg, M.NewRoundStepMessage):
                advanced = msg.height > ps.prs.height
                ps.apply_new_round_step(msg)
                if advanced and self.switch is not None:
                    # peer height moved: height-gated mempool gossip may
                    # now have sendable txs for it
                    mp = self.switch.reactor("mempool")
                    if mp is not None and hasattr(mp, "wake"):
                        mp.wake()
            elif isinstance(msg, M.CommitStepMessage):
                ps.apply_commit_step(msg)
            elif isinstance(msg, M.HasVoteMessage):
                ps.set_has_vote(msg.height, msg.round, msg.type, msg.index)
            elif isinstance(msg, M.VoteSetMaj23Message):
                self._on_vote_set_maj23(peer, ps, msg)
            elif isinstance(msg, M.ProposalHeartbeatMessage):
                hb = msg.heartbeat
                # observability only (reference :214-218 logs it) — but
                # authenticate before attributing: any peer could spoof a
                # heartbeat naming another validator.  Gated on the debug
                # level: the verify (pure-Python fallback ~10ms) must not
                # become a receive-thread stall amplifier feeding a log
                # line that default levels discard.
                if log.enabled(DEBUG):
                    rs = self.cs.get_round_state()
                    val = (rs.validators.get_by_address(hb.validator_address)
                           if rs.validators is not None else None)
                    authentic = (val is not None and val.pub_key.verify(
                        hb.sign_bytes(self.cs.state.chain_id), hb.signature))
                    log.debug("proposal heartbeat", peer=peer.id[:8],
                              height=hb.height, round=hb.round,
                              seq=hb.sequence, authentic=authentic)
        elif ch_id == DATA_CHANNEL:
            if self.fast_sync:
                return
            if isinstance(msg, M.ProposalMessage):
                total = msg.proposal.block_parts_header.total
                if total > MAX_BLOCK_PARTS:
                    self.switch.stop_peer_for_error(
                        peer, f"proposal of {total} parts")
                    return
                ps.set_has_proposal(msg.proposal)
                # dedup prefilter: N peers each relay the round's proposal,
                # and the serialized core would drop the copies anyway
                # (`_set_proposal` keeps the first) — skipping them here
                # keeps redundant work off the single consensus thread.
                # Safe against the queue's async lag: once a proposal for
                # (h, r) is set, a second one only becomes acceptable
                # after a round/height change, which also invalidates it.
                rs = self.cs.get_round_state()
                p = msg.proposal
                if not (rs.proposal is not None and rs.height == p.height
                        and rs.round == p.round):
                    self.cs.set_proposal(p, peer.id)
            elif isinstance(msg, M.ProposalPOLMessage):
                ps.apply_proposal_pol(msg)
            elif isinstance(msg, M.BlockPartMessage):
                ps.set_has_part(msg.height, msg.part.index)
                rs = self.cs.get_round_state()
                parts = rs.proposal_block_parts
                # duplicate only if the part is OF our current partset
                # (proof roots at its header) AND we already hold that
                # index — "same index" alone is not identity: a catchup
                # part for the committed block must not be dropped
                # because our own later-round proposal happens to fill
                # the same slot (stress-tier wedge: heights [25,25,0,25])
                if not (rs.height == msg.height and parts is not None and
                        0 <= msg.part.index < parts.total and
                        parts.has_part(msg.part.index) and
                        msg.part.verify(parts.header)):
                    self.cs.add_proposal_block_part(msg.height, msg.round,
                                                    msg.part, peer.id)
        elif ch_id == VOTE_CHANNEL:
            if self.fast_sync:
                return
            if isinstance(msg, M.VoteMessage):
                v = msg.vote
                rs = self.cs.get_round_state()
                n = rs.validators.size() if rs.validators else None
                ps.set_has_vote(v.height, v.round, v.type,
                                v.validator_index, n)
                if not self._core_has_vote(rs, v):
                    self.cs.add_vote(v, peer.id)
        elif ch_id == VOTE_SET_BITS_CHANNEL:
            if isinstance(msg, M.VoteSetBitsMessage):
                rs = self.cs.get_round_state()
                ps.apply_vote_set_bits(
                    msg, None, rs.validators.size() if rs.validators else None)

    @staticmethod
    def _core_has_vote(rs, v) -> bool:
        """Dedup prefilter: True iff the core already holds EXACTLY this
        vote (same block, same signature).  Conflicting votes (different
        block for the same slot) must still go through — they are
        equivocation evidence.  A stale False only costs one queue item
        the core drops itself, so races are harmless."""
        if v.height == rs.height and rs.votes is not None:
            vs = (rs.votes.prevotes(v.round) if v.type == TYPE_PREVOTE
                  else rs.votes.precommits(v.round))
        elif (v.height + 1 == rs.height and rs.last_commit is not None
              and v.type == TYPE_PRECOMMIT
              and v.round == rs.last_commit.round):
            vs = rs.last_commit
        else:
            return False
        if vs is None or not (0 <= v.validator_index < vs.size()):
            return False
        ex = vs.get_by_index(v.validator_index)
        return (ex is not None and
                ex.block_id.key() == v.block_id.key() and
                ex.signature == v.signature)

    def _on_vote_set_maj23(self, peer: Peer, ps: PeerState,
                           msg: M.VoteSetMaj23Message) -> None:
        """Track the claim and answer with our bits for that block
        (reference :216-249)."""
        try:
            self.cs.set_peer_maj23(msg.height, msg.round, msg.type,
                                   peer.id, msg.block_id)
        except ValueError as e:
            self.switch.stop_peer_for_error(peer, f"bad maj23: {e}")
            return
        rs = self.cs.get_round_state()
        if rs.height != msg.height or rs.votes is None:
            return
        vs = (rs.votes.prevotes(msg.round) if msg.type == TYPE_PREVOTE
              else rs.votes.precommits(msg.round))
        if vs is None:
            return
        peer.try_send(VOTE_SET_BITS_CHANNEL, M.encode_msg(
            M.VoteSetBitsMessage(
                height=msg.height, round=msg.round, type=msg.type,
                block_id=msg.block_id,
                votes_bits=tuple(vs.bit_array_by_block_id(msg.block_id)))))

    # -- gossip routines -------------------------------------------------
    def _gossip_data_routine(self, peer: Peer, ps: PeerState,
                             stop: threading.Event) -> None:
        """Reference `gossipDataRoutine` :413-491 — event-driven: the
        sequence is snapshotted BEFORE each scan, so any state change
        that lands mid-scan retriggers immediately instead of being lost
        to the wait."""
        while not stop.is_set():
            seq = self._wake_seq
            if not self._gossip_data_once(peer, ps):
                self._wait_work(seq, self.gossip_sleep)

    def _gossip_data_once(self, peer: Peer, ps: PeerState) -> bool:
        rs = self.cs.get_round_state()
        prs = ps.prs
        # 1. same height/round: send missing block parts — but only once
        #    the peer has the proposal (its parts bit-array is initialized
        #    by set_has_proposal); receivers drop parts that arrive before
        #    the ProposalMessage, so gossiping parts first would livelock
        #    (reference gossipDataRoutine gates on ProposalBlockParts too).
        if rs.proposal_block_parts is not None and \
                rs.height == prs.height and rs.round == prs.round and \
                prs.proposal_block_parts is not None:
            parts = rs.proposal_block_parts
            ours = [parts.has_part(i) for i in range(parts.total)]
            idx = ps.pick_missing(ours, prs.proposal_block_parts)
            if idx is not None:
                part = parts.get_part(idx)
                if peer.send(DATA_CHANNEL, M.encode_msg(
                        M.BlockPartMessage(rs.height, rs.round, part))):
                    ps.set_has_part(rs.height, idx)
                    return True
                return False
        # 2. peer behind: feed it the committed block at its height
        if 0 < prs.height < rs.height and \
                prs.height <= self.cs.block_store.height:
            meta = self.cs.block_store.load_block_meta(prs.height)
            if meta is not None:
                # (re)key the model to the COMMITTED block's header — a
                # bitmap tracking the peer's own later-round proposal
                # must not stand in for it (see init_proposal_block_parts)
                ps.init_proposal_block_parts(meta.block_id.parts)
                ours = [True] * meta.block_id.parts.total
                idx = ps.pick_missing(ours, prs.proposal_block_parts)
                if idx is not None:
                    part = self.cs.block_store.load_part(prs.height, idx)
                    if part is not None and peer.send(
                            DATA_CHANNEL, M.encode_msg(M.BlockPartMessage(
                                prs.height, prs.round, part))):
                        ps.set_has_part(prs.height, idx)
                        return True
                    return False
        # 3. send the proposal itself (+ POL)
        if rs.proposal is not None and rs.height == prs.height and \
                rs.round == prs.round and not prs.proposal:
            if peer.send(DATA_CHANNEL,
                         self._stamp(M.ProposalMessage(rs.proposal))):
                ps.set_has_proposal(rs.proposal)
            if 0 <= rs.proposal.pol_round and rs.votes is not None:
                pol = rs.votes.prevotes(rs.proposal.pol_round)
                if pol is not None:
                    peer.send(DATA_CHANNEL, M.encode_msg(
                        M.ProposalPOLMessage(
                            height=rs.height,
                            proposal_pol_round=rs.proposal.pol_round,
                            proposal_pol=tuple(pol.bit_array()))))
            return True
        return False

    def _gossip_votes_routine(self, peer: Peer, ps: PeerState,
                              stop: threading.Event) -> None:
        """Reference `gossipVotesRoutine` :537-643 — event-driven (see
        `_gossip_data_routine`)."""
        while not stop.is_set():
            seq = self._wake_seq
            if not self._gossip_votes_once(peer, ps):
                self._wait_work(seq, self.gossip_sleep)

    def _send_vote_from(self, peer: Peer, ps: PeerState, vs) -> bool:
        """Send one vote from vs the peer is missing.

        The peer's bit-array is keyed by the VOTE SET's own
        (height, round, type) — the reference's PickSendVote via
        getVoteBitArray.  Keying by any other round (e.g. the peer's
        advertised previous-height last_commit_round) wedges catchup: a
        vote the model calls missing but the peer already has gets
        re-sent forever while the votes it actually lacks never go out.
        """
        if vs is None:
            return False
        with ps._lock:
            theirs = ps._bits_for(vs.height, vs.round, vs.type, vs.size())
            if theirs is None:
                # no trackable slot for this (height, round) on the peer
                # (e.g. NEW_HEIGHT peer whose commit round differs from
                # ours): sending would be an untracked resend hot-loop —
                # the reference's PickSendVote also bails on a nil
                # bit-array; other catchup branches cover the peer
                return False
            theirs = list(theirs)
        idx = ps.pick_missing(vs.bit_array(), theirs)
        if idx is None:
            return False
        vote = vs.get_by_index(idx)
        if vote is None:
            return False
        if peer.send(VOTE_CHANNEL, self._stamp(M.VoteMessage(vote))):
            ps.set_has_vote(vote.height, vote.round, vote.type, idx,
                            vs.size())
            return True
        return False

    def _gossip_votes_once(self, peer: Peer, ps: PeerState) -> bool:
        rs = self.cs.get_round_state()
        prs = ps.prs
        if rs.height == prs.height and rs.votes is not None:
            # peer waiting for the last commit at NewHeight
            if prs.step == STEP_NEW_HEIGHT and rs.last_commit is not None:
                if self._send_vote_from(peer, ps, rs.last_commit):
                    return True
            if prs.round >= 0 and prs.round <= rs.round:
                pv = rs.votes.prevotes(prs.round)
                if prs.step <= STEP_PREVOTE and \
                        self._send_vote_from(peer, ps, pv):
                    return True
                pc = rs.votes.precommits(prs.round)
                if prs.step <= STEP_PRECOMMIT_WAIT and \
                        self._send_vote_from(peer, ps, pc):
                    return True
                # commit-step peers still need precommits of their round
                if self._send_vote_from(peer, ps, pc):
                    return True
            if prs.proposal_pol_round >= 0:
                pol = rs.votes.prevotes(prs.proposal_pol_round)
                if self._send_vote_from(peer, ps, pol):
                    return True
            return False
        # peer one height behind: our last_commit completes their commit
        if prs.height != 0 and rs.height == prs.height + 1 and \
                rs.last_commit is not None:
            if self._send_vote_from(peer, ps, rs.last_commit):
                return True
        # peer far behind: seen-commit precommits from the store
        if prs.height != 0 and prs.height < rs.height and \
                prs.height <= self.cs.block_store.height:
            commit = self.cs.block_store.load_seen_commit(prs.height)
            if commit is not None:
                ps.ensure_catchup_commit(prs.height, commit.round(),
                                         commit.size())
                votes = [v for v in commit.precommits if v is not None]
                with ps._lock:
                    theirs = ps.prs.catchup_commit
                    cands = [v for v in votes
                             if theirs is None or
                             not theirs[v.validator_index]]
                if cands:
                    vote = random.choice(cands)
                    if peer.send(VOTE_CHANNEL,
                                 self._stamp(M.VoteMessage(vote))):
                        ps.set_has_vote(vote.height, vote.round, vote.type,
                                        vote.validator_index, commit.size())
                        return True
        return False

    def _query_maj23_routine(self, peer: Peer, ps: PeerState,
                             stop: threading.Event) -> None:
        """Advertise our two-thirds majorities so peers can prove theirs
        (reference `queryMaj23Routine` :647-753)."""
        while not stop.is_set():
            if stop.wait(MAJ23_SLEEP):
                return
            rs = self.cs.get_round_state()
            prs = ps.prs
            # belt-and-braces for the commit-wait wedge: while we sit
            # in Commit missing parts, periodically re-advertise our
            # REAL parts bitmap to this peer so a sender whose model
            # drifted (marked parts delivered that we dropped
            # pre-commit) re-sends them
            if (rs.step == STEP_COMMIT and
                    rs.proposal_block_parts is not None and
                    not rs.proposal_block_parts.is_complete()):
                msg = self.cs.commit_step_message()
                if msg is not None:
                    peer.try_send(STATE_CHANNEL, M.encode_msg(msg))
            if rs.height != prs.height or rs.votes is None:
                continue
            for type_, getter in ((TYPE_PREVOTE, rs.votes.prevotes),
                                  (TYPE_PRECOMMIT, rs.votes.precommits)):
                for r in range(0, rs.round + 1):
                    vs = getter(r)
                    maj = vs.two_thirds_majority() if vs else None
                    if maj is not None:
                        peer.try_send(STATE_CHANNEL, M.encode_msg(
                            M.VoteSetMaj23Message(
                                height=rs.height, round=r, type=type_,
                                block_id=maj)))
