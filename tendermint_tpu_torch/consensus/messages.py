"""Consensus message codec: gossip payloads and WAL records.

Reference: the reactor's wire messages (`consensus/reactor.go:1186-1352`)
and the WAL's msgInfo records (`consensus/wal.go:21-27`).  Each message is
u8(tag) || payload with the deterministic codec; WAL records additionally
carry the peer id so replay reproduces the exact input stream.
Copy of `tendermint_tpu/consensus/messages.py`, byte for byte the same
codec.
"""

from __future__ import annotations

from dataclasses import dataclass

from tendermint_tpu_torch.types import BlockID, Vote
from tendermint_tpu_torch.types.codec import Reader, lp_bytes, u32, u64, u8
from tendermint_tpu_torch.types.part_set import Part
from tendermint_tpu_torch.types.proposal import Heartbeat, Proposal

TAG_PROPOSAL = 0x01
TAG_BLOCK_PART = 0x02
TAG_VOTE = 0x03
TAG_NEW_ROUND_STEP = 0x11
TAG_COMMIT_STEP = 0x12
TAG_HAS_VOTE = 0x13
TAG_VOTE_SET_MAJ23 = 0x14
TAG_VOTE_SET_BITS = 0x15
TAG_PROPOSAL_POL = 0x16
TAG_PROPOSAL_HEARTBEAT = 0x17
TAG_STAMPED = 0x18


@dataclass(frozen=True)
class ProposalMessage:
    proposal: Proposal


@dataclass(frozen=True)
class BlockPartMessage:
    height: int
    round: int
    part: Part


@dataclass(frozen=True)
class VoteMessage:
    vote: Vote


@dataclass(frozen=True)
class NewRoundStepMessage:
    height: int
    round: int
    step: int
    seconds_since_start: int
    last_commit_round: int


@dataclass(frozen=True)
class CommitStepMessage:
    height: int
    parts_total: int
    parts_bits: tuple


@dataclass(frozen=True)
class HasVoteMessage:
    height: int
    round: int
    type: int
    index: int


@dataclass(frozen=True)
class VoteSetMaj23Message:
    height: int
    round: int
    type: int
    block_id: BlockID


@dataclass(frozen=True)
class VoteSetBitsMessage:
    height: int
    round: int
    type: int
    block_id: BlockID
    votes_bits: tuple


@dataclass(frozen=True)
class ProposalPOLMessage:
    height: int
    proposal_pol_round: int
    proposal_pol: tuple


@dataclass(frozen=True)
class ProposalHeartbeatMessage:
    """Proposer liveness signal while waiting for txs
    (reference `consensus/reactor.go:214`, `consensus/state.go:820-847`)."""
    heartbeat: object          # types.proposal.Heartbeat


@dataclass(frozen=True)
class StampedMessage:
    """Gossip envelope carrying the origin's send time (timeline plane).

    Wraps a vote/proposal/block-part payload so the receiver can measure
    per-link fan-out lag (ingest time minus sent_ts).  sent_ts rides the
    sender's monotonic-anchored epoch axis (`tracing.now_epoch`), encoded
    as u64 nanoseconds; cross-host clock skew makes the lag a lower
    bound, so receivers clamp negatives to zero.  Reactor-layer only:
    the consensus core and its WAL see the unwrapped inner message."""
    msg: object                 # the wrapped consensus message
    sent_ts: float = 0.0        # origin epoch seconds (0 = unstamped)
    origin: str = ""            # origin node id ("" = use peer id)


def _bits_encode(bits) -> bytes:
    out = u32(len(bits))
    by = bytearray((len(bits) + 7) // 8)
    for i, b in enumerate(bits):
        if b:
            by[i // 8] |= 1 << (i % 8)
    return out + bytes(by)


def _bits_decode(r: Reader) -> tuple:
    n = r.u32()
    by = r.fixed((n + 7) // 8)
    return tuple(bool(by[i // 8] >> (i % 8) & 1) for i in range(n))


def encode_msg(msg) -> bytes:
    if isinstance(msg, ProposalMessage):
        return u8(TAG_PROPOSAL) + msg.proposal.encode()
    if isinstance(msg, BlockPartMessage):
        return (u8(TAG_BLOCK_PART) + u64(msg.height) + u32(msg.round) +
                msg.part.encode())
    if isinstance(msg, VoteMessage):
        return u8(TAG_VOTE) + msg.vote.encode()
    if isinstance(msg, NewRoundStepMessage):
        return (u8(TAG_NEW_ROUND_STEP) + u64(msg.height) + u32(msg.round) +
                u8(msg.step) + u32(msg.seconds_since_start) +
                u32(msg.last_commit_round + 1))
    if isinstance(msg, CommitStepMessage):
        return (u8(TAG_COMMIT_STEP) + u64(msg.height) +
                u32(msg.parts_total) + _bits_encode(msg.parts_bits))
    if isinstance(msg, HasVoteMessage):
        return (u8(TAG_HAS_VOTE) + u64(msg.height) + u32(msg.round) +
                u8(msg.type) + u32(msg.index))
    if isinstance(msg, VoteSetMaj23Message):
        return (u8(TAG_VOTE_SET_MAJ23) + u64(msg.height) + u32(msg.round) +
                u8(msg.type) + msg.block_id.encode())
    if isinstance(msg, VoteSetBitsMessage):
        return (u8(TAG_VOTE_SET_BITS) + u64(msg.height) + u32(msg.round) +
                u8(msg.type) + msg.block_id.encode() +
                _bits_encode(msg.votes_bits))
    if isinstance(msg, ProposalPOLMessage):
        return (u8(TAG_PROPOSAL_POL) + u64(msg.height) +
                u32(msg.proposal_pol_round + 1) +
                _bits_encode(msg.proposal_pol))
    if isinstance(msg, ProposalHeartbeatMessage):
        return u8(TAG_PROPOSAL_HEARTBEAT) + msg.heartbeat.encode()
    if isinstance(msg, StampedMessage):
        return (u8(TAG_STAMPED) + u64(int(msg.sent_ts * 1e9)) +
                lp_bytes(msg.origin.encode()) + encode_msg(msg.msg))
    raise TypeError(f"cannot encode {type(msg).__name__}")


def decode_msg(data: bytes):
    r = Reader(data)
    tag = r.u8()
    if tag == TAG_PROPOSAL:
        return ProposalMessage(Proposal.decode(r))
    if tag == TAG_BLOCK_PART:
        return BlockPartMessage(height=r.u64(), round=r.u32(),
                                part=Part.decode(r))
    if tag == TAG_VOTE:
        return VoteMessage(Vote.decode(r))
    if tag == TAG_NEW_ROUND_STEP:
        return NewRoundStepMessage(height=r.u64(), round=r.u32(),
                                   step=r.u8(),
                                   seconds_since_start=r.u32(),
                                   last_commit_round=r.u32() - 1)
    if tag == TAG_COMMIT_STEP:
        return CommitStepMessage(height=r.u64(), parts_total=r.u32(),
                                 parts_bits=_bits_decode(r))
    if tag == TAG_HAS_VOTE:
        return HasVoteMessage(height=r.u64(), round=r.u32(), type=r.u8(),
                              index=r.u32())
    if tag == TAG_VOTE_SET_MAJ23:
        return VoteSetMaj23Message(height=r.u64(), round=r.u32(),
                                   type=r.u8(), block_id=BlockID.decode(r))
    if tag == TAG_VOTE_SET_BITS:
        return VoteSetBitsMessage(height=r.u64(), round=r.u32(), type=r.u8(),
                                  block_id=BlockID.decode(r),
                                  votes_bits=_bits_decode(r))
    if tag == TAG_PROPOSAL_POL:
        return ProposalPOLMessage(height=r.u64(),
                                  proposal_pol_round=r.u32() - 1,
                                  proposal_pol=_bits_decode(r))
    if tag == TAG_PROPOSAL_HEARTBEAT:
        return ProposalHeartbeatMessage(Heartbeat.decode(r))
    if tag == TAG_STAMPED:
        sent_ts = r.u64() / 1e9
        origin = r.lp_bytes().decode()
        inner = decode_msg(r.buf[r.pos:])
        if isinstance(inner, StampedMessage):
            raise ValueError("nested stamped envelope")
        return StampedMessage(msg=inner, sent_ts=sent_ts, origin=origin)
    raise ValueError(f"unknown consensus message tag {tag:#x}")
