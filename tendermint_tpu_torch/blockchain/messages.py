"""Fast-sync wire messages.

Reference: `blockchain/reactor.go:273-289` — BlockRequest, BlockResponse,
NoBlockResponse, StatusRequest, StatusResponse on channel 0x40.  Copy of
`tendermint_tpu/blockchain/messages.py`.
"""

from __future__ import annotations

from dataclasses import dataclass

from tendermint_tpu_torch.types import Block
from tendermint_tpu_torch.types.codec import Reader, lp_bytes, u64, u8

TAG_BLOCK_REQUEST = 0x01
TAG_BLOCK_RESPONSE = 0x02
TAG_NO_BLOCK_RESPONSE = 0x03
TAG_STATUS_REQUEST = 0x04
TAG_STATUS_RESPONSE = 0x05


@dataclass(frozen=True)
class BlockRequest:
    height: int


@dataclass(frozen=True)
class BlockResponse:
    block_bytes: bytes          # decoded lazily: hashing is the hot path

    def block(self) -> Block:
        return Block.decode_bytes(self.block_bytes)


@dataclass(frozen=True)
class NoBlockResponse:
    height: int


@dataclass(frozen=True)
class StatusRequest:
    pass


@dataclass(frozen=True)
class StatusResponse:
    height: int


def encode_msg(msg) -> bytes:
    if isinstance(msg, BlockRequest):
        return u8(TAG_BLOCK_REQUEST) + u64(msg.height)
    if isinstance(msg, BlockResponse):
        return u8(TAG_BLOCK_RESPONSE) + lp_bytes(msg.block_bytes)
    if isinstance(msg, NoBlockResponse):
        return u8(TAG_NO_BLOCK_RESPONSE) + u64(msg.height)
    if isinstance(msg, StatusRequest):
        return u8(TAG_STATUS_REQUEST)
    if isinstance(msg, StatusResponse):
        return u8(TAG_STATUS_RESPONSE) + u64(msg.height)
    raise TypeError(f"cannot encode {type(msg).__name__}")


def decode_msg(data: bytes):
    r = Reader(data)
    tag = r.u8()
    if tag == TAG_BLOCK_REQUEST:
        return BlockRequest(r.u64())
    if tag == TAG_BLOCK_RESPONSE:
        return BlockResponse(r.lp_bytes())
    if tag == TAG_NO_BLOCK_RESPONSE:
        return NoBlockResponse(r.u64())
    if tag == TAG_STATUS_REQUEST:
        return StatusRequest()
    if tag == TAG_STATUS_RESPONSE:
        return StatusResponse(r.u64())
    raise ValueError(f"unknown blockchain message tag {tag:#x}")
