"""Snapshot creation + on-disk format.

Layout under a snapshot root directory:

    snapshots/
      snapshot-0000000500/
        chunk-000000.bin
        chunk-000001.bin
        ...
        manifest.json        # written LAST, via tmp + atomic rename

The chunked payload is `lp(state_bytes) || lp(app_state_bytes)` split
into fixed-size chunks; the manifest commits to every chunk hash
(0x00-domain-separated SHA-256 leaf hashes, same tree as every other
Merkle structure here) and their root.  Failure semantics mirror the
consensus WAL's CRC framing philosophy:

- the manifest is written last and carries a crc32 of its canonical
  body, so a crash at ANY point of snapshot creation leaves either a
  chunk directory with no (or a torn) manifest — discarded on scan —
  or a complete, verifiable snapshot;
- a manifest whose listed chunk hashes don't re-root to its `root`
  field is discarded (a lying or bit-rotted manifest never offers);
- chunk files are re-hashed against the manifest on `verify()` (the
  `cli snapshot verify` path) and at restore time, so disk corruption
  after a clean write is caught before any byte reaches the app.

Copy of `tendermint_tpu/statesync/snapshot.py` with the port's rules.
Chunk hashing takes the backend it is given (`hash_chunks(chunks,
backend)`, `SnapshotStore(..., backend=)`): at least
`_DEVICE_MIN_CHUNKS` chunks of one length go through the backend's
`leaf_hashes` (`crypto.backend.leaf_hasher`) — kernel K4 on a
`CudaBackend` or on a supervised ladder whose first rung is one, the host
library's threaded SHA-256 on the native rung — and everything else
through the host tree (`types.merkle`).
The JAX version's peek at the installed backend, its
`TM_SNAPSHOT_DEVICE_HASH` switch and its `except Exception` host fallback
are gone: with no backend the host loop hashes, and a failed launch
raises.  The JAX chunk and snapshot metrics and its two fail points
(`utils/fail.py`) are kept.
"""

from __future__ import annotations

import json
import os
import time
import zlib
from collections import Counter
from dataclasses import dataclass

import numpy as np

from tendermint_tpu_torch.crypto.backend import leaf_hasher
from tendermint_tpu_torch.types import merkle as hmerkle
from tendermint_tpu_torch.utils.fail import fail_point
from tendermint_tpu_torch.utils.log import get_logger
from tendermint_tpu_torch.utils.metrics import REGISTRY

log = get_logger("statesync")

SNAPSHOT_SCHEMA = "tpu-bft-snapshot/1"
SNAPSHOT_FORMAT = 1
DEFAULT_CHUNK_SIZE = 64 * 1024
DEFAULT_RETAIN = 2
MANIFEST_NAME = "manifest.json"

# below this many equal-length chunks a batched call costs more than the
# host loop; the differential tests pin both paths to identical hashes
_DEVICE_MIN_CHUNKS = 8


# -- payload ----------------------------------------------------------------

def encode_payload(state_bytes: bytes, app_state: bytes) -> bytes:
    """`lp(state) || lp(app_state)` — one blob the chunker splits."""
    return (len(state_bytes).to_bytes(4, "big") + state_bytes +
            len(app_state).to_bytes(4, "big") + app_state)


def decode_payload(payload: bytes) -> tuple[bytes, bytes]:
    if len(payload) < 4:
        raise ValueError("snapshot payload truncated (no state length)")
    n = int.from_bytes(payload[:4], "big")
    state_bytes = payload[4:4 + n]
    if len(state_bytes) != n:
        raise ValueError("snapshot payload truncated (state)")
    rest = payload[4 + n:]
    if len(rest) < 4:
        raise ValueError("snapshot payload truncated (no app length)")
    m = int.from_bytes(rest[:4], "big")
    app_state = rest[4:4 + m]
    if len(app_state) != m or len(rest) != 4 + m:
        raise ValueError("snapshot payload truncated (app state)")
    return state_bytes, app_state


def split_chunks(payload: bytes, chunk_size: int) -> list[bytes]:
    if chunk_size <= 0:
        raise ValueError(f"chunk_size must be positive, got {chunk_size}")
    if not payload:
        return [b""]
    return [payload[i:i + chunk_size]
            for i in range(0, len(payload), chunk_size)]


def hash_chunks(chunks: list[bytes], backend=None) -> list[bytes]:
    """Leaf hash per chunk.  The chunks of the most common length (every
    chunk of a snapshot but a possibly-short tail) go through `backend`'s
    batched `leaf_hashes` in one call when there are at least
    `_DEVICE_MIN_CHUNKS` of them and the backend has one (`leaf_hasher`).
    The rest hash on the host: the tail, a chunk of another length (a
    peer's or the disk's fault, which then fails its hash check), any small
    batch, and every chunk when there is no such backend."""
    out: list[bytes | None] = [None] * len(chunks)
    hasher = leaf_hasher(backend)
    if hasher is not None and len(chunks) >= _DEVICE_MIN_CHUNKS:
        width = Counter(map(len, chunks)).most_common(1)[0][0]
        rows = [i for i, c in enumerate(chunks) if len(c) == width]
        if width > 0 and len(rows) >= _DEVICE_MIN_CHUNKS:
            data = np.frombuffer(b"".join(chunks[i] for i in rows),
                                 dtype=np.uint8)
            hashed = np.asarray(hasher(data.reshape(len(rows), width)))
            for k, i in enumerate(rows):
                out[i] = hashed[k].tobytes()
    return [h if h is not None else hmerkle.leaf_hash(c)
            for c, h in zip(chunks, out)]


def verify_chunk_hashes(chunks: dict[int, bytes],
                        expected: tuple[bytes, ...],
                        backend=None) -> list[int]:
    """Indices whose chunk bytes do NOT hash to the manifest's
    commitment.  One batched call over everything fetched."""
    idxs = sorted(chunks)
    hashed = hash_chunks([chunks[i] for i in idxs], backend)
    bad = [i for i, h in zip(idxs, hashed) if h != expected[i]]
    if len(idxs) - len(bad):
        REGISTRY.chunks_verified.inc(len(idxs) - len(bad))
    if bad:
        REGISTRY.chunks_rejected.inc(len(bad))
    return bad


# -- manifest ---------------------------------------------------------------

@dataclass(frozen=True)
class SnapshotManifest:
    height: int
    format: int
    chunk_size: int
    chunk_hashes: tuple[bytes, ...]
    root: bytes
    app_hash: bytes

    @property
    def chunks(self) -> int:
        return len(self.chunk_hashes)

    def key(self) -> tuple:
        """Identity for cross-peer offer matching: two peers offering
        the same (height, format, root, app_hash) offer the same
        snapshot.  app_hash is part of the identity so a forged
        manifest that reuses honest chunks (same root) but lies about
        the app hash forms its OWN offer group — blamed on its own
        providers, never mixed into the honest group."""
        return (self.height, self.format, self.root, self.app_hash)

    def canonical_body(self) -> dict:
        return {
            "schema": SNAPSHOT_SCHEMA, "height": self.height,
            "format": self.format, "chunk_size": self.chunk_size,
            "chunk_hashes": [h.hex() for h in self.chunk_hashes],
            "root": self.root.hex(), "app_hash": self.app_hash.hex(),
        }

    def encode_json(self) -> bytes:
        body = self.canonical_body()
        raw = json.dumps(body, sort_keys=True,
                         separators=(",", ":")).encode()
        body["crc32"] = zlib.crc32(raw)
        return json.dumps(body, sort_keys=True).encode()

    @classmethod
    def decode_json(cls, raw: bytes) -> "SnapshotManifest":
        """Parse + integrity-check a manifest.  Raises ValueError on a
        torn/garbled file, a CRC mismatch, or chunk hashes that don't
        re-root to the committed root."""
        try:
            d = json.loads(raw)
        except (json.JSONDecodeError, UnicodeDecodeError) as e:
            raise ValueError(f"torn manifest: {e}") from None
        if not isinstance(d, dict) or d.get("schema") != SNAPSHOT_SCHEMA:
            raise ValueError(f"not a {SNAPSHOT_SCHEMA} manifest")
        crc = d.pop("crc32", None)
        canon = json.dumps(d, sort_keys=True,
                           separators=(",", ":")).encode()
        if crc != zlib.crc32(canon):
            raise ValueError("manifest crc32 mismatch (torn write)")
        m = cls(height=int(d["height"]), format=int(d["format"]),
                chunk_size=int(d["chunk_size"]),
                chunk_hashes=tuple(bytes.fromhex(h)
                                   for h in d["chunk_hashes"]),
                root=bytes.fromhex(d["root"]),
                app_hash=bytes.fromhex(d["app_hash"]))
        if hmerkle.root_from_leaf_hashes(list(m.chunk_hashes)) != m.root:
            raise ValueError("manifest chunk hashes do not re-root to "
                             "the committed root")
        return m


# -- store ------------------------------------------------------------------

class SnapshotStore:
    """Disk-backed snapshot collection with retention.

    `create()` is the only writer; every reader revalidates (manifest
    CRC + root re-check) so a torn snapshot — crash mid-create, fsck'd
    disk — is silently unavailable rather than silently wrong.  Chunks
    are hashed through `backend` (`hash_chunks`)."""

    def __init__(self, root_dir: str,
                 chunk_size: int = DEFAULT_CHUNK_SIZE,
                 retain: int = DEFAULT_RETAIN, backend=None):
        if retain < 1:
            raise ValueError(f"retain must be >= 1, got {retain}")
        self.root_dir = root_dir
        self.chunk_size = chunk_size
        self.retain = retain
        self.backend = backend
        os.makedirs(root_dir, exist_ok=True)

    # -- paths ----------------------------------------------------------
    def snapshot_dir(self, height: int) -> str:
        return os.path.join(self.root_dir, f"snapshot-{height:010d}")

    @staticmethod
    def _chunk_path(sdir: str, index: int) -> str:
        return os.path.join(sdir, f"chunk-{index:06d}.bin")

    # -- create ---------------------------------------------------------
    def create(self, state, app_state: bytes) -> SnapshotManifest:
        """Snapshot `state` (a state.State at its committed height) +
        the serialized app state.  Chunks land first, the manifest last
        via tmp + atomic rename; then retention prunes old heights."""
        t0 = time.time()
        height = state.last_block_height
        if height <= 0:
            raise ValueError("cannot snapshot at height 0")
        payload = encode_payload(state.encode(), app_state)
        chunks = split_chunks(payload, self.chunk_size)
        hashes = hash_chunks(chunks, self.backend)
        manifest = SnapshotManifest(
            height=height, format=SNAPSHOT_FORMAT,
            chunk_size=self.chunk_size, chunk_hashes=tuple(hashes),
            root=hmerkle.root_from_leaf_hashes(hashes),
            app_hash=state.app_hash)
        sdir = self.snapshot_dir(height)
        os.makedirs(sdir, exist_ok=True)
        for i, chunk in enumerate(chunks):
            with open(self._chunk_path(sdir, i), "wb") as f:
                f.write(chunk)
                f.flush()
                os.fsync(f.fileno())
            fail_point("Snapshot.chunkWritten")
        fail_point("Snapshot.chunksWritten")
        tmp = os.path.join(sdir, MANIFEST_NAME + ".tmp")
        with open(tmp, "wb") as f:
            f.write(manifest.encode_json())
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, os.path.join(sdir, MANIFEST_NAME))
        self.prune_retained()
        dt = time.time() - t0
        REGISTRY.snapshots_created.inc()
        REGISTRY.snapshot_create_seconds.observe(dt)
        log.info("snapshot created", height=height,
                 chunks=len(chunks), bytes=len(payload),
                 seconds=round(dt, 3))
        return manifest

    # -- scan / load ----------------------------------------------------
    def scan(self) -> tuple[list[SnapshotManifest], list[tuple[str, str]]]:
        """(valid manifests ascending by height, [(dir, why)] rejects).
        Scanning never raises on a bad snapshot — a torn dir is evidence
        of a crash, not an error to propagate."""
        valid: list[SnapshotManifest] = []
        rejects: list[tuple[str, str]] = []
        try:
            names = sorted(os.listdir(self.root_dir))
        except FileNotFoundError:
            return [], []
        for name in names:
            sdir = os.path.join(self.root_dir, name)
            if not name.startswith("snapshot-") or not os.path.isdir(sdir):
                continue
            mpath = os.path.join(sdir, MANIFEST_NAME)
            if not os.path.exists(mpath):
                rejects.append((sdir, "no manifest (torn create)"))
                continue
            try:
                with open(mpath, "rb") as f:
                    m = SnapshotManifest.decode_json(f.read())
            except (OSError, ValueError) as e:
                rejects.append((sdir, str(e)))
                continue
            if self.snapshot_dir(m.height) != sdir:
                rejects.append((sdir, f"manifest height {m.height} does "
                                      f"not match directory name"))
                continue
            valid.append(m)
        return valid, rejects

    def list(self) -> list[SnapshotManifest]:
        return self.scan()[0]

    def best(self) -> SnapshotManifest | None:
        valid = self.list()
        return valid[-1] if valid else None

    def load_manifest(self, height: int) -> SnapshotManifest | None:
        mpath = os.path.join(self.snapshot_dir(height), MANIFEST_NAME)
        try:
            with open(mpath, "rb") as f:
                return SnapshotManifest.decode_json(f.read())
        except (OSError, ValueError):
            return None

    def load_chunk(self, height: int, index: int) -> bytes | None:
        try:
            with open(self._chunk_path(self.snapshot_dir(height), index),
                      "rb") as f:
                return f.read()
        except OSError:
            return None

    # -- verify (the `cli snapshot verify` engine) ----------------------
    def verify(self, height: int) -> dict:
        """Re-hash every chunk against the manifest.  Returns
        {height, ok, manifest_ok, chunks, bad_chunks, missing_chunks};
        `ok` only when the manifest validates AND every chunk is present
        and hashes to its commitment."""
        report = {"height": height, "ok": False, "manifest_ok": False,
                  "chunks": 0, "bad_chunks": [], "missing_chunks": []}
        m = self.load_manifest(height)
        if m is None:
            return report
        report["manifest_ok"] = True
        report["chunks"] = m.chunks
        present: dict[int, bytes] = {}
        for i in range(m.chunks):
            chunk = self.load_chunk(height, i)
            if chunk is None:
                report["missing_chunks"].append(i)
            else:
                present[i] = chunk
        report["bad_chunks"] = verify_chunk_hashes(present, m.chunk_hashes,
                                                   self.backend)
        report["ok"] = not (report["bad_chunks"]
                            or report["missing_chunks"])
        return report

    # -- retention ------------------------------------------------------
    @staticmethod
    def _remove_dir(sdir: str) -> None:
        for name in os.listdir(sdir):
            try:
                os.unlink(os.path.join(sdir, name))
            except OSError:
                pass
        try:
            os.rmdir(sdir)
        except OSError:
            pass

    def delete(self, height: int) -> None:
        sdir = self.snapshot_dir(height)
        if os.path.isdir(sdir):
            self._remove_dir(sdir)

    def prune_retained(self) -> list[int]:
        """Keep the newest `retain` VALID snapshots; drop the rest (and
        any torn directory older than the newest valid one — a torn dir
        NEWER than every valid snapshot is kept for post-mortem)."""
        valid, rejects = self.scan()
        dropped: list[int] = []
        for m in valid[:-self.retain] if len(valid) > self.retain else []:
            self.delete(m.height)
            dropped.append(m.height)
        if valid:
            newest = self.snapshot_dir(valid[-1].height)
            for sdir, _why in rejects:
                if sdir < newest:
                    self._remove_dir(sdir)
        return dropped
