"""Fixed-layout sign-bytes — the contract between consensus and the TPU.

The reference signs reflection-generated canonical JSON (reference
`types/canonical_json.go:44-58`, `types/vote.go:60-66`).  This framework
instead defines a *fixed 128-byte* binary layout so that a batch of N votes
is an `uint8[N, 128]` array assembled with pure memory moves (numpy
host-side) — no per-item serialization — and the device kernel hashes and
verifies thousands in lockstep (`tendermint_tpu_torch.ops.ed25519`).

Layout (big-endian, zero-padded to 128 bytes):

    off  len  field
    0    4    magic  b"TMS1"  (framework sign-bytes, version 1)
    4    1    msg type        (1=prevote 2=precommit 3=proposal 4=heartbeat)
    5    3    zero padding
    8    32   sha256(chain_id)
    40   8    height   u64
    48   4    round    u32
    52   32   block hash       (zeros = nil vote)
    84   32   part-set hash    (zeros = nil)
    116  4    part-set total   u32
    120  4    pol_round + 1    u32 (proposals; 0 = no POL)   [votes: 0]
    124  4    zero padding

Every field is fixed-width; chain IDs of any length hash to 32 bytes.  A
vote's sign-bytes are therefore reconstructable on device from the tuple
(chain_hash, height, round, type, block_id) — the property SURVEY.md §7
calls out as hard requirement #2.
"""

from __future__ import annotations

import hashlib

import numpy as np

SIGN_BYTES_LEN = 128
MAGIC = b"TMS1"

TYPE_PREVOTE = 1
TYPE_PRECOMMIT = 2
TYPE_PROPOSAL = 3
TYPE_HEARTBEAT = 4

_OFF_TYPE = 4
_OFF_CHAIN = 8
_OFF_HEIGHT = 40
_OFF_ROUND = 48
_OFF_BLOCKHASH = 52
_OFF_PARTSHASH = 84
_OFF_PARTSTOTAL = 116
_OFF_POLROUND = 120


def chain_hash(chain_id: str) -> bytes:
    return hashlib.sha256(chain_id.encode()).digest()


def sign_bytes(chain_id: str, msg_type: int, height: int, round_: int,
               block_hash: bytes = b"", parts_hash: bytes = b"",
               parts_total: int = 0, pol_round: int = -1) -> bytes:
    """One record, host path (device batch path: `batch_sign_bytes`)."""
    # hashes are exactly 32 bytes or absent — a wire-decoded value of any
    # other length must never silently shift the fixed layout
    if block_hash and len(block_hash) != 32:
        raise ValueError(f"block_hash must be 32 bytes, got {len(block_hash)}")
    if parts_hash and len(parts_hash) != 32:
        raise ValueError(f"parts_hash must be 32 bytes, got {len(parts_hash)}")
    buf = bytearray(SIGN_BYTES_LEN)
    buf[0:4] = MAGIC
    buf[_OFF_TYPE] = msg_type
    buf[_OFF_CHAIN:_OFF_CHAIN + 32] = chain_hash(chain_id)
    buf[_OFF_HEIGHT:_OFF_HEIGHT + 8] = height.to_bytes(8, "big")
    buf[_OFF_ROUND:_OFF_ROUND + 4] = round_.to_bytes(4, "big")
    if block_hash:
        buf[_OFF_BLOCKHASH:_OFF_BLOCKHASH + 32] = block_hash
    if parts_hash:
        buf[_OFF_PARTSHASH:_OFF_PARTSHASH + 32] = parts_hash
    buf[_OFF_PARTSTOTAL:_OFF_PARTSTOTAL + 4] = parts_total.to_bytes(4, "big")
    buf[_OFF_POLROUND:_OFF_POLROUND + 4] = (pol_round + 1).to_bytes(4, "big")
    return bytes(buf)


def batch_sign_bytes(chain_id: str, msg_types: np.ndarray,
                     heights: np.ndarray, rounds: np.ndarray,
                     block_hashes: np.ndarray,
                     parts_hashes: np.ndarray,
                     parts_totals: np.ndarray) -> np.ndarray:
    """Vectorized assembly: N votes -> uint8[N, 128] with no Python loop.

    block_hashes/parts_hashes are uint8[N, 32] (zero rows = nil).
    """
    n = len(heights)
    buf = np.zeros((n, SIGN_BYTES_LEN), dtype=np.uint8)
    buf[:, 0:4] = np.frombuffer(MAGIC, dtype=np.uint8)
    buf[:, _OFF_TYPE] = msg_types.astype(np.uint8)
    buf[:, _OFF_CHAIN:_OFF_CHAIN + 32] = np.frombuffer(chain_hash(chain_id),
                                                       dtype=np.uint8)
    h = heights.astype(">u8").view(np.uint8).reshape(n, 8)
    buf[:, _OFF_HEIGHT:_OFF_HEIGHT + 8] = h
    r = rounds.astype(">u4").view(np.uint8).reshape(n, 4)
    buf[:, _OFF_ROUND:_OFF_ROUND + 4] = r
    buf[:, _OFF_BLOCKHASH:_OFF_BLOCKHASH + 32] = block_hashes
    buf[:, _OFF_PARTSHASH:_OFF_PARTSHASH + 32] = parts_hashes
    t = parts_totals.astype(">u4").view(np.uint8).reshape(n, 4)
    buf[:, _OFF_PARTSTOTAL:_OFF_PARTSTOTAL + 4] = t
    # votes carry pol_round = -1 -> stored 0 == already zeroed
    return buf
