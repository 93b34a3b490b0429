"""PartSet: blocks chunked into Merkle-proved parts for gossip.

Reference: `types/part_set.go` — serialized block split into 64KB parts
(`types/block.go:18-19,115-117`), each part hashed into a simple Merkle
tree with per-part inclusion proofs verified on receive
(`types/part_set.go:95-122,188-214`).  Different peers serve different
parts concurrently; the proof lets a receiver validate each part against
the proposal's PartSetHeader before assembly.

`from_data_batched` is the fast-sync path: the bulk hashing (full 64KB
part chunks, the dominant cost of re-hashing big blocks) runs as ONE
lockstep device batch, while the irregular work (short tail chunks, tree
and proof assembly) stays on the host — the reference re-hashes each
block serially on the CPU inside its sync loop
(`blockchain/reactor.go:224`, `types/part_set.go:95-122`).

Copy of `tendermint_tpu/types/part_set.py`; a batch of at least
`DEVICE_MIN_CHUNKS` full chunks is hashed by the caller's backend's
`leaf_hashes` (K4 on the card) instead of a process-wide one's, and with
no such backend by the native library's threaded `tm_leaf_hashes`
(`utils.nativelib`), as in the JAX package; its build failing raises.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
from torch.profiler import record_function

from tendermint_tpu_torch.crypto.backend import leaf_hasher
from tendermint_tpu_torch.types import merkle
from tendermint_tpu_torch.types.codec import Reader, lp_bytes, u32
from tendermint_tpu_torch.utils import nativelib

PART_SIZE = 64 * 1024  # reference types/block.go:19

# Below this many full-size chunks in a batch the host's C hashing wins
# (device dispatch + transfer overhead); above, lockstep lanes win.
DEVICE_MIN_CHUNKS = 16


@dataclass(frozen=True)
class PartSetHeader:
    total: int
    hash: bytes

    def is_zero(self) -> bool:
        return self.total == 0 and not self.hash

    def encode(self) -> bytes:
        return u32(self.total) + lp_bytes(self.hash)

    @classmethod
    def decode(cls, r: Reader) -> "PartSetHeader":
        return cls(total=r.u32(), hash=r.lp_bytes())

    def __str__(self):
        return f"{self.total}:{self.hash.hex()[:12]}"


ZERO_PSH = PartSetHeader(0, b"")


@dataclass(frozen=True)
class Part:
    index: int
    bytes_: bytes
    proof: merkle.Proof

    def verify(self, header: PartSetHeader) -> bool:
        if self.index != self.proof.index or self.proof.total != header.total:
            return False
        if merkle.leaf_hash(self.bytes_) != self.proof.leaf:
            return False
        return self.proof.verify(header.hash)

    def encode(self) -> bytes:
        out = u32(self.index) + lp_bytes(self.bytes_)
        out += u32(self.proof.total) + u32(self.proof.index)
        out += lp_bytes(self.proof.leaf) + u32(len(self.proof.aunts))
        for a in self.proof.aunts:
            out += lp_bytes(a)
        return out

    @classmethod
    def decode(cls, r: Reader) -> "Part":
        index = r.u32()
        data = r.lp_bytes()
        total, pidx = r.u32(), r.u32()
        leaf = r.lp_bytes()
        aunts = tuple(r.lp_bytes() for _ in range(r.u32()))
        return cls(index, data, merkle.Proof(total, pidx, leaf, aunts))


class PartSet:
    """A complete or in-progress set of parts for one block."""

    def __init__(self, header: PartSetHeader):
        self.header = header
        self._parts: list[Part | None] = [None] * header.total
        self._count = 0

    @classmethod
    def from_data(cls, data: bytes, part_size: int = PART_SIZE) -> "PartSet":
        """Chunk serialized block bytes into proved parts
        (reference `types/part_set.go:95-122`)."""
        return from_data_batched([data], part_size)[0]

    @classmethod
    def _assemble(cls, chunks: list[bytes],
                  leaf_hashes: list[bytes]) -> "PartSet":
        rt, proofs = merkle.proofs_from_leaf_hashes(leaf_hashes)
        ps = cls(PartSetHeader(len(chunks), rt))
        for i, (c, pr) in enumerate(zip(chunks, proofs)):
            ps._parts[i] = Part(i, c, pr)
        ps._count = len(chunks)
        return ps

    def add_part(self, part: Part) -> bool:
        """Verify against the header and store; False on invalid/duplicate
        index mismatch (reference `types/part_set.go:188-214`)."""
        if not (0 <= part.index < self.header.total):
            return False
        if self._parts[part.index] is not None:
            return False
        if not part.verify(self.header):
            return False
        self._parts[part.index] = part
        self._count += 1
        return True

    def get_part(self, index: int) -> Part | None:
        return self._parts[index]

    def has_part(self, index: int) -> bool:
        return self._parts[index] is not None

    @property
    def count(self) -> int:
        return self._count

    @property
    def total(self) -> int:
        return self.header.total

    def is_complete(self) -> bool:
        return self._count == self.header.total

    def bit_array(self) -> list[bool]:
        return [p is not None for p in self._parts]

    def assemble(self) -> bytes:
        assert self.is_complete()
        return b"".join(p.bytes_ for p in self._parts)


def _full_chunk_hashes(chunks: list[bytes], part_size: int,
                       backend) -> list[bytes] | None:
    """Leaf-hash equal-size chunks in one batch: through the backend's
    `leaf_hashes` (`crypto.backend.leaf_hasher`: K4 on the card), else the
    native library's threaded `tm_leaf_hashes`.  None below
    `DEVICE_MIN_CHUNKS`, where host hashlib wins."""
    if len(chunks) < DEVICE_MIN_CHUNKS:
        return None
    hasher = leaf_hasher(backend) or nativelib.leaf_hashes
    with record_function("part_set.join"):
        arr = np.frombuffer(b"".join(chunks), np.uint8).reshape(-1,
                                                                part_size)
    with record_function("part_set.leaf_hashes"):
        h = hasher(arr)
        return [h[i].tobytes() for i in range(len(chunks))]


def from_data_batched(datas: list[bytes], part_size: int = PART_SIZE,
                      backend=None) -> list["PartSet"]:
    """Build PartSets for MANY serialized blocks at once.

    All full-size (== part_size) chunks across the whole window are leaf-
    hashed in one batch through `backend`'s `leaf_hashes` (when it has
    one and the batch is big enough); short tail chunks and the
    per-block tree/proof assembly stay host-side.  Each step is a
    `torch.profiler` span: `part_set.chunk`, `part_set.join` and
    `part_set.leaf_hashes` (the batch) and `part_set.trees`.
    """
    per_block: list[list[bytes]] = []
    full: list[tuple[int, int]] = []     # (block, part) of full chunks
    full_chunks: list[bytes] = []
    with record_function("part_set.chunk"):
        for bi, data in enumerate(datas):
            chunks = [data[i:i + part_size]
                      for i in range(0, len(data), part_size)] or [b""]
            per_block.append(chunks)
            for pi, c in enumerate(chunks):
                if len(c) == part_size:
                    full.append((bi, pi))
                    full_chunks.append(c)
    hashes: list[list[bytes | None]] = [[None] * len(c) for c in per_block]
    dev = _full_chunk_hashes(full_chunks, part_size, backend)
    if dev is not None:
        for (bi, pi), h in zip(full, dev):
            hashes[bi][pi] = h
    out = []
    with record_function("part_set.trees"):
        for bi, chunks in enumerate(per_block):
            lh = [h if h is not None else merkle.leaf_hash(c)
                  for c, h in zip(chunks, hashes[bi])]
            out.append(PartSet._assemble(chunks, lh))
    return out
