"""Votes: the signed consensus message.

Copy of the `Vote` type of `tendermint_tpu/types/vote.py` (reference
`types/vote.go`).  The vote-set tally engine belongs to consensus and
waits for a later slice of the port.
"""

from __future__ import annotations

from dataclasses import dataclass

from tendermint_tpu_torch.types import canonical
from tendermint_tpu_torch.types.codec import Reader, lp_bytes, u32, u64, u8

# re-exported vote types
TYPE_PREVOTE = canonical.TYPE_PREVOTE
TYPE_PRECOMMIT = canonical.TYPE_PRECOMMIT


def _block_id():
    # deferred import: block.py imports Vote for Commit
    from tendermint_tpu_torch.types.block import BlockID
    return BlockID


@dataclass(frozen=True)
class Vote:
    validator_address: bytes
    validator_index: int
    height: int
    round: int
    type: int                      # TYPE_PREVOTE | TYPE_PRECOMMIT
    block_id: "object"             # BlockID; zero = nil vote
    signature: bytes = b""

    def validate_basic(self) -> None:
        """Structural checks on wire-decoded votes: every length is fixed
        so a malformed vote can never shift the sign-bytes layout or a
        batch verifier's lanes."""
        if self.type not in (TYPE_PREVOTE, TYPE_PRECOMMIT):
            raise ValueError(f"bad vote type {self.type}")
        if len(self.validator_address) != 20:
            raise ValueError("validator address must be 20 bytes")
        if self.validator_index < 0 or self.height < 1 or self.round < 0:
            raise ValueError("negative vote index/height/round")
        bid = self.block_id
        if bid.hash and len(bid.hash) != 32:
            raise ValueError("block hash must be 32 bytes or empty")
        if bid.parts.hash and len(bid.parts.hash) != 32:
            raise ValueError("parts hash must be 32 bytes or empty")
        if len(self.signature) != 64:
            raise ValueError("signature must be 64 bytes")

    def sign_bytes(self, chain_id: str) -> bytes:
        return canonical.sign_bytes(
            chain_id, self.type, self.height, self.round,
            block_hash=self.block_id.hash,
            parts_hash=self.block_id.parts.hash,
            parts_total=self.block_id.parts.total)

    def is_nil(self) -> bool:
        return self.block_id.is_zero()

    def encode(self) -> bytes:
        return (lp_bytes(self.validator_address) + u32(self.validator_index) +
                u64(self.height) + u32(self.round) + u8(self.type) +
                self.block_id.encode() + lp_bytes(self.signature))

    @classmethod
    def decode(cls, r: Reader) -> "Vote":
        BlockID = _block_id()
        return cls(validator_address=r.lp_bytes(), validator_index=r.u32(),
                   height=r.u64(), round=r.u32(), type=r.u8(),
                   block_id=BlockID.decode(r), signature=r.lp_bytes())

    def __str__(self):
        t = {1: "prevote", 2: "precommit"}.get(self.type, f"t{self.type}")
        tgt = "nil" if self.is_nil() else self.block_id.hash.hex()[:12]
        return (f"Vote[{self.validator_index}:"
                f"{self.validator_address.hex()[:8]} {self.height}/"
                f"{self.round} {t} -> {tgt}]")
