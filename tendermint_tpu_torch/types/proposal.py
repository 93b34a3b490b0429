"""Proposal and heartbeat messages.

Reference: `types/proposal.go` (signed block proposal with POL round for
lock changes) and `types/heartbeat.go` (proposer liveness signal).
Copy of `tendermint_tpu/types/proposal.py`.
"""

from __future__ import annotations

from dataclasses import dataclass

from tendermint_tpu_torch.types import canonical
from tendermint_tpu_torch.types.codec import Reader, i64, lp_bytes, u32, u64
from tendermint_tpu_torch.types.part_set import PartSetHeader


@dataclass(frozen=True)
class Proposal:
    height: int
    round: int
    block_parts_header: PartSetHeader
    pol_round: int = -1            # -1: no proof-of-lock
    pol_block_id: "object" = None  # BlockID | None
    signature: bytes = b""

    def sign_bytes(self, chain_id: str) -> bytes:
        pol = self.pol_block_id
        return canonical.sign_bytes(
            chain_id, canonical.TYPE_PROPOSAL, self.height, self.round,
            block_hash=(pol.hash if pol is not None else b""),
            parts_hash=self.block_parts_header.hash,
            parts_total=self.block_parts_header.total,
            pol_round=self.pol_round)

    def encode(self) -> bytes:
        from tendermint_tpu_torch.types.block import ZERO_BLOCK_ID
        pol = self.pol_block_id if self.pol_block_id is not None else ZERO_BLOCK_ID
        return (u64(self.height) + u32(self.round) +
                self.block_parts_header.encode() + i64(self.pol_round) +
                pol.encode() + lp_bytes(self.signature))

    @classmethod
    def decode(cls, r: Reader) -> "Proposal":
        from tendermint_tpu_torch.types.block import BlockID
        height, round_ = r.u64(), r.u32()
        parts = PartSetHeader.decode(r)
        pol_round = r.i64()
        pol_block_id = BlockID.decode(r)
        sig = r.lp_bytes()
        if pol_block_id.is_zero():
            pol_block_id = None
        return cls(height, round_, parts, pol_round, pol_block_id, sig)

    def __str__(self):
        return (f"Proposal[{self.height}/{self.round} "
                f"parts {self.block_parts_header} pol {self.pol_round}]")


@dataclass(frozen=True)
class Heartbeat:
    validator_address: bytes
    validator_index: int
    height: int
    round: int
    sequence: int
    signature: bytes = b""

    def sign_bytes(self, chain_id: str) -> bytes:
        # reuse the fixed frame: sequence rides in the parts_total slot
        if len(self.validator_address) > 32:
            raise ValueError("validator address too long")
        return canonical.sign_bytes(
            chain_id, canonical.TYPE_HEARTBEAT, self.height, self.round,
            block_hash=self.validator_address.ljust(32, b"\x00"),
            parts_total=self.sequence)

    def encode(self) -> bytes:
        # index -1 = sender is not a validator (reference Heartbeat
        # carries ValidatorIndex -1 for observers); shift like the other
        # minus-one-able wire fields
        return (lp_bytes(self.validator_address) +
                u32(self.validator_index + 1) +
                u64(self.height) + u32(self.round) + u64(self.sequence) +
                lp_bytes(self.signature))

    @classmethod
    def decode(cls, r: Reader) -> "Heartbeat":
        return cls(validator_address=r.lp_bytes(),
                   validator_index=r.u32() - 1,
                   height=r.u64(), round=r.u32(), sequence=r.u64(),
                   signature=r.lp_bytes())
