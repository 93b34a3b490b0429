"""State-sync wire messages (channel 0x60).

The rig-level restore path talks to `SnapshotStore`s directly through
`StoreSource`; these messages are the same protocol spelled for the p2p
layer — a recovering node broadcasts SnapshotsRequest, providers answer
with their manifests, and chunks stream back one ChunkRequest at a time
(NoChunkResponse for pruned/unknown chunks, mirroring fast-sync's
NoBlockResponse so a syncer can rotate providers instead of hanging).
Codec-complete now so the reactor, when it lands, inherits a tested
vocabulary.  Copy of `tendermint_tpu/statesync/messages.py`.
"""

from __future__ import annotations

from dataclasses import dataclass

from tendermint_tpu_torch.statesync.snapshot import SnapshotManifest
from tendermint_tpu_torch.types.codec import Reader, lp_bytes, u32, u64, u8

STATESYNC_CHANNEL = 0x60

TAG_SNAPSHOTS_REQUEST = 0x01
TAG_SNAPSHOTS_RESPONSE = 0x02
TAG_CHUNK_REQUEST = 0x03
TAG_CHUNK_RESPONSE = 0x04
TAG_NO_CHUNK_RESPONSE = 0x05


@dataclass(frozen=True)
class SnapshotsRequest:
    pass


@dataclass(frozen=True)
class SnapshotsResponse:
    manifests: tuple[SnapshotManifest, ...]


@dataclass(frozen=True)
class ChunkRequest:
    height: int
    index: int


@dataclass(frozen=True)
class ChunkResponse:
    height: int
    index: int
    chunk: bytes


@dataclass(frozen=True)
class NoChunkResponse:
    height: int
    index: int


def encode_msg(msg) -> bytes:
    if isinstance(msg, SnapshotsRequest):
        return u8(TAG_SNAPSHOTS_REQUEST)
    if isinstance(msg, SnapshotsResponse):
        # manifests ride as their JSON encoding: the CRC frame travels
        # with them, so a receiver rejects a corrupt manifest the same
        # way it rejects a torn one on disk
        return (u8(TAG_SNAPSHOTS_RESPONSE) + u32(len(msg.manifests)) +
                b"".join(lp_bytes(m.encode_json())
                         for m in msg.manifests))
    if isinstance(msg, ChunkRequest):
        return u8(TAG_CHUNK_REQUEST) + u64(msg.height) + u32(msg.index)
    if isinstance(msg, ChunkResponse):
        return (u8(TAG_CHUNK_RESPONSE) + u64(msg.height) +
                u32(msg.index) + lp_bytes(msg.chunk))
    if isinstance(msg, NoChunkResponse):
        return (u8(TAG_NO_CHUNK_RESPONSE) + u64(msg.height) +
                u32(msg.index))
    raise TypeError(f"cannot encode {type(msg).__name__}")


def decode_msg(data: bytes):
    r = Reader(data)
    tag = r.u8()
    if tag == TAG_SNAPSHOTS_REQUEST:
        return SnapshotsRequest()
    if tag == TAG_SNAPSHOTS_RESPONSE:
        n = r.u32()
        return SnapshotsResponse(tuple(
            SnapshotManifest.decode_json(r.lp_bytes()) for _ in range(n)))
    if tag == TAG_CHUNK_REQUEST:
        return ChunkRequest(r.u64(), r.u32())
    if tag == TAG_CHUNK_RESPONSE:
        return ChunkResponse(r.u64(), r.u32(), r.lp_bytes())
    if tag == TAG_NO_CHUNK_RESPONSE:
        return NoChunkResponse(r.u64(), r.u32())
    raise ValueError(f"unknown statesync message tag {tag:#x}")
