"""Pluggable crypto backends: the seam between consensus and the card.

Port of `tendermint_tpu/crypto/backend.py`, trimmed to two backends behind
the reference's `Backend` protocol: `PythonBackend` (the golden bigint
verifier) and `CudaBackend` (the hand-written CUDA kernels of
`ops.ed25519`, named "cuda").  Batches are padded to power-of-two buckets
by repeating lane 0, and padded lanes are trimmed from every result.

`CudaBackend` runs on the card unless the caller passes device="cpu", in
which case every kernel wrapper runs its plain PyTorch version; with no
card it refuses to start.  Its templated grouped verify also has an
asynchronous form (`prefetch_grouped_lanes`,
`verify_grouped_templated_async`): lanes are staged in page-locked host
memory and copied, verified (K1) and copied back on a CUDA stream the
backend owns, and the caller collects the mask later.  Given a
`parallel.sharding.Mesh`, its large
grouped verifies split their lanes over the mesh, with the comb tables
replicated on every mesh device; a templated batch keeps its device-side
gather of keys and messages on every shard.  Unlike the JAX package's
`TpuBackend`, it builds no mesh of its own on a multi-card host: on four
H100s one replay window verified more slowly split over the cards than
on one.
"""

from __future__ import annotations

import hashlib
import threading
from typing import Protocol

import numpy as np
import torch

from tendermint_tpu_torch.crypto import pure_ed25519 as _ref
from tendermint_tpu_torch.ops import curve
from tendermint_tpu_torch.ops import ed25519 as ed
from tendermint_tpu_torch.ops import merkle
from tendermint_tpu_torch.parallel import sharding

MIN_BUCKET = 16


class Backend(Protocol):
    name: str

    def verify_batch(self, pubkeys: np.ndarray, msgs: np.ndarray,
                     sigs: np.ndarray) -> np.ndarray:
        """uint8 [N,32] pubkeys, [N,M] msgs (equal-length), [N,64] sigs
        -> bool[N]."""
        ...

    def verify_grouped(self, set_key: bytes, val_pubs: np.ndarray,
                       val_idx: np.ndarray, msgs: np.ndarray,
                       sigs: np.ndarray) -> np.ndarray:
        """Verify N signatures made by members of a FIXED key set: lane i
        was signed by val_pubs[val_idx[i]].  set_key identifies the set so
        device backends can cache per-set comb tables across calls.
        Semantics identical to verify_batch(val_pubs[val_idx], ...)."""
        ...


def _bucket(n: int) -> int:
    b = MIN_BUCKET
    while b < n:
        b *= 2
    return b


def _host(a) -> np.ndarray:
    """A lane array as numpy, copied back if it lies on a device."""
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _pad_rows(a: np.ndarray, b: int) -> np.ndarray:
    """Pad the leading axis to b rows by repeating row 0."""
    if b == len(a):
        return a
    return np.concatenate([a, np.repeat(a[:1], b - len(a), 0)])


class PythonBackend:
    """Golden bigint implementation — slow, obviously correct."""
    name = "python"

    def verify_batch(self, pubkeys, msgs, sigs):
        from tendermint_tpu_torch.types.keys import _verify_memo
        out = np.zeros(len(pubkeys), dtype=bool)
        for i in range(len(pubkeys)):
            out[i] = _verify_memo(pubkeys[i].tobytes(), msgs[i].tobytes(),
                                  sigs[i].tobytes())
        return out

    def verify_grouped(self, set_key, val_pubs, val_idx, msgs, sigs):
        return self.verify_batch(val_pubs[val_idx], msgs, sigs)

    def verify_grouped_templated(self, set_key, val_pubs, val_idx, tmpl_idx,
                                 templates, sigs):
        return self.verify_grouped(set_key, val_pubs, val_idx,
                                   templates[tmpl_idx], sigs)

    def prefetch_grouped_lanes(self, val_idx, tmpl_idx, templates, sigs):
        """Nothing to copy: the lanes as they are, and their count."""
        return val_idx, tmpl_idx, templates, sigs, len(val_idx)

    def verify_grouped_templated_async(self, set_key, val_pubs, val_idx,
                                       tmpl_idx, templates, sigs,
                                       real_n: int | None = None):
        """Verifies at once; `collect()` returns the result."""
        n = len(val_idx) if real_n is None else real_n
        out = self.verify_grouped_templated(
            set_key, val_pubs, np.asarray(val_idx)[:n],
            np.asarray(tmpl_idx)[:n], templates, np.asarray(sigs)[:n])
        return lambda: out


class CudaBackend:
    """The port's CUDA kernels (`ops.ed25519`, `ops.merkle`) with shape
    bucketing, a per-validator-set comb-table cache and, with a mesh, the
    sharded grouped verify (`parallel.sharding`)."""
    name = "cuda"

    # Comb tables are ~2.5 MB per validator (uint8), so the cache is
    # bounded in bytes (FIFO eviction), as in the reference: a 128-validator
    # set costs ~327 MB, an 8-validator light chain ~41 MB.
    TABLE_CACHE_BYTES = 4 << 30

    # below this many lanes per device the split costs more than the
    # parallelism buys (single gossiped votes stay on one device)
    MIN_LANES_PER_DEVICE = 1024

    def __init__(self, device: str | torch.device = "cuda",
                 mesh: sharding.Mesh | None = None):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "CudaBackend: no CUDA device available (pass device='cpu' "
                "to run the plain PyTorch versions of the kernels)")
        self._mesh = mesh
        self._base = ed.base_table(self.device)
        if mesh is not None:
            self._base_mesh = sharding.replicate(mesh, self._base)
            self._sharded_verify = sharding.sharded_grouped_verify_fn(mesh)
            self._sharded_templated = \
                sharding.sharded_grouped_templated_verify_fn(mesh)
        # set_key -> (tables, pub_ok, real set size, padded key matrix)
        self._tables: dict[bytes, tuple] = {}
        # set_key -> (tables, pub_ok, padded key matrix) replicated over
        # the mesh, installed and evicted with the `_tables` entry
        self._replicas: dict[bytes, tuple] = {}
        # digest of the seed set -> (a, prefix, pubkey) matrices
        self._sign_keys: dict[bytes, tuple] = {}
        self._lock = threading.Lock()
        # one table build at a time, so two threads that miss the cache
        # for the same set build it once
        self._build_lock = threading.Lock()
        # the asynchronous route's copies and K1 launches
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)
        # synchronous grouped calls (`verify_grouped`) so far: the
        # consensus vote micro-batch threshold reads it
        # (`ConsensusState._microbatch_threshold`)
        self.step_count = 0

    def _t(self, a: np.ndarray) -> torch.Tensor:
        return torch.tensor(np.asarray(a), device=self.device)

    # -- comb tables -----------------------------------------------------
    def tables_cached(self, set_key: bytes) -> bool:
        with self._lock:
            return set_key in self._tables

    def _install(self, set_key: bytes, tbl: torch.Tensor, ok: torch.Tensor,
                 v: int, padded_pubs: np.ndarray) -> tuple:
        """Cache a set's tables (and, with a mesh, one replica per distinct
        mesh device); FIFO eviction past TABLE_CACHE_BYTES per device."""
        ent = (tbl, ok, v, self._t(padded_pubs))
        reps = self._replicate(ent) if self._mesh is not None else None
        with self._lock:
            resident = sum(e[0].numel() for e in self._tables.values())
            while (self._tables and
                   resident + tbl.numel() > self.TABLE_CACHE_BYTES):
                oldest = next(iter(self._tables))
                resident -= self._tables.pop(oldest)[0].numel()
                self._replicas.pop(oldest, None)
            self._tables[set_key] = ent
            if reps is not None:
                self._replicas[set_key] = reps
        return ent

    def _replicate(self, ent: tuple) -> tuple:
        """A cache entry's tables, pub_ok and padded key matrix, one
        replica per mesh shard (one copy per distinct device)."""
        tbl, ok, _, vp = ent
        return tuple(sharding.replicate(self._mesh, x) for x in (tbl, ok, vp))

    def _mesh_tables(self, set_key: bytes, ent: tuple) -> tuple:
        with self._lock:
            reps = self._replicas.get(set_key)
        # None: evicted since `tables` returned the entry
        return reps if reps is not None else self._replicate(ent)

    def tables(self, set_key: bytes, val_pubs: np.ndarray) -> tuple:
        """Fetch or build the comb tables for a key set: (tables, pub_ok,
        set size, padded key matrix), all on the device.  The set is padded
        to a power of two by repeating key 0 (so a handful of table shapes
        cover any set size); the padded columns are copies of column 0, so
        only the real keys are built."""
        with self._lock:
            ent = self._tables.get(set_key)
        if ent is None:
            with self._build_lock:
                with self._lock:
                    ent = self._tables.get(set_key)
                if ent is None:
                    return self._build(set_key, val_pubs)
        if ent[2] != len(val_pubs):
            raise ValueError(
                f"set_key reused for a different set size ({ent[2]} != "
                f"{len(val_pubs)})")
        return ent

    def _build(self, set_key: bytes, val_pubs: np.ndarray) -> tuple:
        """Build a set's tables (K2) on the caller's current stream and
        install them."""
        v = len(val_pubs)
        vb = _bucket(v)
        tbl, ok = ed.build_neg_comb(self._t(val_pubs))
        if vb > v:
            tbl = torch.cat([tbl, tbl[:, :, :1].expand(
                -1, -1, vb - v, -1, -1)], dim=2).contiguous()
            ok = torch.cat([ok, ok[:1].expand(vb - v)])
        return self._install(set_key, tbl, ok, v, _pad_rows(val_pubs, vb))

    def tables_from_numpy(self, set_key: bytes, val_pubs: np.ndarray,
                          tbl: np.ndarray, ok: np.ndarray,
                          pubs_sha256: np.ndarray | None = None) -> None:
        """Install comb tables built elsewhere — the reference's
        `build_neg_comb` output or the arrays of its `.npz` table cache
        (keys `tbl`, `ok`, `pubs_sha256`) — as this backend's tables for
        `set_key`.  `tbl` is uint8[26, 1024, Vb, 3, 32] with Vb >= the set
        size; `val_pubs` are the set's real keys, padded here to Vb by
        repeating key 0 (the reference's padding), and `pubs_sha256`, when
        given, must be the SHA-256 of that padded key matrix."""
        v = len(val_pubs)
        want = (curve.COMB_WINDOWS, curve.COMB_DIGITS)
        if tbl.dtype != np.uint8 or tbl.ndim != 5 or tbl.shape[:2] != want \
                or tbl.shape[3:] != (3, 32):
            raise ValueError(f"tables: bad shape/dtype {tbl.shape} "
                             f"{tbl.dtype}")
        vb = tbl.shape[2]
        if vb < v or ok.shape != (vb,):
            raise ValueError(f"tables hold {vb} keys, ok {ok.shape}, set "
                             f"has {v}")
        padded = _pad_rows(np.asarray(val_pubs, np.uint8), vb)
        if pubs_sha256 is not None and \
                np.asarray(pubs_sha256, np.uint8).tobytes() != \
                hashlib.sha256(padded.tobytes()).digest():
            raise ValueError("pubs_sha256 does not match the key set")
        self._install(set_key, self._t(tbl), self._t(ok.astype(bool)), v,
                      padded)

    # -- verification ----------------------------------------------------
    @staticmethod
    def _check_idx(name: str, idx: np.ndarray,
                   bound: int | None = None) -> np.ndarray:
        """idx as int32, each in [0, bound) (bound None: >= 0)."""
        idx = np.asarray(idx, dtype=np.int32)
        if len(idx) and (idx.min() < 0 or
                         (bound is not None and idx.max() >= bound)):
            raise ValueError(f"{name} out of range [0, {bound})")
        return idx

    def _templates(self, templates: np.ndarray) -> torch.Tensor:
        """Templates padded with zero rows to a power-of-two count."""
        tb = _bucket(len(templates))
        return self._t(np.concatenate(
            [templates, np.zeros((tb - len(templates), templates.shape[1]),
                                 np.uint8)]))

    def templated_args(self, set_key, val_pubs, val_idx, tmpl_idx,
                       templates, sigs) -> tuple:
        """Device arguments of `ed25519.verify_grouped_templated` for one
        batch: the set's tables (built on first use), its padded key
        matrix, and lanes padded to a power of two by repeating lane 0."""
        tbl, ok, _, vp = self.tables(set_key, val_pubs)
        val_idx = self._check_idx("val_idx", val_idx, len(val_pubs))
        tmpl_idx = self._check_idx("tmpl_idx", tmpl_idx, len(templates))
        b = _bucket(len(val_idx))
        return (tbl, ok, vp, self._t(_pad_rows(val_idx, b)),
                self._t(_pad_rows(tmpl_idx, b)), self._templates(templates),
                self._t(_pad_rows(sigs, b)), self._base)

    def _mesh_eligible(self, bucket: int) -> bool:
        if self._mesh is None:
            return False
        n_dev = self._mesh.size
        return (bucket % n_dev == 0 and
                bucket >= self.MIN_LANES_PER_DEVICE * n_dev)

    def verify_grouped_templated(self, set_key, val_pubs, val_idx, tmpl_idx,
                                 templates, sigs) -> np.ndarray:
        """Grouped verify shipping only (sig, val_idx, tmpl_idx) lanes plus
        T message templates; messages and keys are gathered on the device
        (kernel K1).  A bucket of at least MIN_LANES_PER_DEVICE lanes per
        mesh device splits its lanes over the mesh, with the templates
        replicated (`sharding.sharded_grouped_templated_verify_fn`)."""
        return self.verify_grouped_templated_async(
            set_key, val_pubs, val_idx, tmpl_idx, templates, sigs)()

    def prefetch_grouped_lanes(self, val_idx, tmpl_idx, templates,
                               sigs) -> tuple:
        """Pad the lanes and templates to this backend's buckets and start
        their host-to-device copies, for a pipeline's prepare stage that
        keeps hashing while the copies run.  On the card the padded
        arrays are staged in page-locked host buffers (fresh ones per
        call: the caching host allocator reuses a buffer only after its
        copy's event) and copied with non_blocking=True on the backend's
        stream, which the later K1 launch shares.  Returns (val_idx,
        tmpl_idx, templates, sigs, real_n): device tensors and the real
        lane count, to pass back through
        `verify_grouped_templated_async(real_n=...)`, which trims its
        result to it.  Indices are checked as far as these arguments
        allow (template indices against the templates, key indices >= 0);
        a key index past the set verifies False (K1's rule)."""
        n = len(val_idx)
        val_idx = self._check_idx("val_idx", val_idx)
        tmpl_idx = self._check_idx("tmpl_idx", tmpl_idx, len(templates))
        b = _bucket(n)
        tb = _bucket(len(templates))
        host = (_pad_rows(val_idx, b), _pad_rows(tmpl_idx, b),
                np.concatenate([templates, np.zeros(
                    (tb - len(templates), templates.shape[1]), np.uint8)]),
                _pad_rows(np.asarray(sigs, np.uint8), b))
        if self._stream is None:
            return (*(torch.from_numpy(np.ascontiguousarray(a))
                      for a in host), n)
        staged = [torch.from_numpy(np.ascontiguousarray(a)).pin_memory()
                  for a in host]
        with torch.cuda.stream(self._stream):
            dev = tuple(p.to(self.device, non_blocking=True) for p in staged)
        return (*dev, n)

    def verify_grouped_templated_async(self, set_key, val_pubs, val_idx,
                                       tmpl_idx, templates, sigs,
                                       real_n: int | None = None):
        """Dispatching half of `verify_grouped_templated`: stage and copy
        the lanes, launch K1 and start the copy of its mask back, all on
        the backend's stream, without waiting; returns a zero-argument
        `collect()` that waits on the copy's event and returns bool[n].
        A pipeline dispatches window k+1 before collecting window k.
        `real_n` marks inputs already padded and copied by
        `prefetch_grouped_lanes`.  K1 waits for everything queued on the
        caller's current stream before it (the set's comb tables are
        built there by K2).  On the mesh route, and on the CPU, the
        result is computed here and `collect` returns it."""
        n = real_n if real_n is not None else len(val_idx)
        if n == 0:
            return lambda: np.zeros(0, dtype=bool)
        ent = self.tables(set_key, val_pubs)
        tbl, ok, _, vp = ent
        b = _bucket(n)
        if self._mesh_eligible(b):
            val_idx, tmpl_idx, templates, sigs = (
                _host(a) for a in (val_idx, tmpl_idx, templates, sigs))
            val_idx = self._check_idx("val_idx", val_idx[:n], len(val_pubs))
            tmpl_idx = self._check_idx("tmpl_idx", tmpl_idx[:n],
                                       len(templates))
            mtbl, mok, mvp = self._mesh_tables(set_key, ent)
            out = self._sharded_templated(
                mtbl, mok, mvp, _pad_rows(val_idx, b), _pad_rows(tmpl_idx, b),
                sharding.replicate(self._mesh, self._templates(templates)),
                _pad_rows(sigs[:n], b), self._base_mesh)
            res = out.cpu().numpy()[:n]
            return lambda: res
        if real_n is None:
            self._check_idx("val_idx", val_idx, len(val_pubs))
            val_idx, tmpl_idx, templates, sigs, _ = \
                self.prefetch_grouped_lanes(val_idx, tmpl_idx, templates,
                                            sigs)
        args = (tbl, ok, vp, val_idx, tmpl_idx, templates, sigs, self._base)
        if self._stream is None:
            res = ed.verify_grouped_templated(*args).numpy()[:n]
            return lambda: res
        s = self._stream
        s.wait_stream(torch.cuda.current_stream(self.device))
        for t in (tbl, ok, vp, self._base):
            t.record_stream(s)
        with torch.cuda.stream(s):
            mask = ed.verify_grouped_templated(*args)
            out = torch.empty(mask.shape, dtype=torch.bool, pin_memory=True)
            out.copy_(mask, non_blocking=True)
            done = torch.cuda.Event()
            done.record(s)

        def collect() -> np.ndarray:
            done.synchronize()
            return out.numpy()[:n]

        return collect

    def verify_grouped(self, set_key, val_pubs, val_idx, msgs,
                       sigs) -> np.ndarray:
        """Lane i checks sigs[i] on msgs[i] by val_pubs[val_idx[i]] against
        the set's comb tables (kernel K1 with per-lane keys and messages);
        lanes padded to a power of two by repeating lane 0.  With a mesh,
        a bucket of at least MIN_LANES_PER_DEVICE lanes per device splits
        over it (`sharding.sharded_grouped_verify_fn`: K1 per shard against
        the replicated tables)."""
        n = len(val_idx)
        if n == 0:
            return np.zeros(0, dtype=bool)
        ent = self.tables(set_key, val_pubs)
        val_idx = self._check_idx("val_idx", val_idx, len(val_pubs))
        b = _bucket(n)
        lanes = tuple(_pad_rows(a, b) for a in (val_idx, val_pubs[val_idx],
                                                msgs, sigs))
        if not self._mesh_eligible(b):
            out = ed.verify_grouped(*ent[:2], *map(self._t, lanes),
                                    self._base)
        else:
            tbl, ok, _ = self._mesh_tables(set_key, ent)
            out = self._sharded_verify(tbl, ok, *lanes, self._base_mesh)
        self.step_count += 1
        return out.cpu().numpy()[:n]

    def verify_batch(self, pubkeys, msgs, sigs) -> np.ndarray:
        """Raw lanes, each with its own key (kernel K5); lanes padded to a
        power of two by repeating lane 0."""
        n = len(pubkeys)
        if n == 0:
            return np.zeros(0, dtype=bool)
        b = _bucket(n)
        out = ed.verify_batch(self._t(_pad_rows(pubkeys, b)),
                              self._t(_pad_rows(msgs, b)),
                              self._t(_pad_rows(sigs, b)), self._base)
        return out.cpu().numpy()[:n]

    # -- signing ---------------------------------------------------------
    def signing_keys(self, seeds) -> tuple:
        """The seed set's (clamped scalar, prefix, pubkey) uint8[V, 32]
        matrices on the device, derived on the host once per set."""
        key = hashlib.sha256(b"".join(bytes(s) for s in seeds)).digest()
        with self._lock:
            ent = self._sign_keys.get(key)
        if ent is None:
            mats = np.zeros((3, len(seeds), 32), np.uint8)
            for i, seed in enumerate(seeds):
                for m, part in zip(mats, _ref.expand_seed(bytes(seed))):
                    m[i] = np.frombuffer(part, np.uint8)
            ent = tuple(self._t(m) for m in mats)
            with self._lock:
                while len(self._sign_keys) >= 16:    # rotating fixture sets
                    self._sign_keys.pop(next(iter(self._sign_keys)))
                self._sign_keys[key] = ent
        return ent

    def sign_args(self, seeds, val_idx, tmpl_idx, templates) -> tuple:
        """Device arguments of `ed25519.sign_grouped_templated`: the seed
        set's `signing_keys` and lanes padded to a power of two."""
        val_idx = self._check_idx("val_idx", val_idx, len(seeds))
        tmpl_idx = self._check_idx("tmpl_idx", tmpl_idx, len(templates))
        b = _bucket(len(val_idx))
        return self.signing_keys(seeds) + (
            self._t(_pad_rows(val_idx, b)), self._t(_pad_rows(tmpl_idx, b)),
            self._templates(templates), self._base)

    def sign_grouped_templated(self, seeds, val_idx, tmpl_idx,
                               templates) -> np.ndarray:
        """Lane i signs templates[tmpl_idx[i]] with seeds[val_idx[i]]
        (kernel K3).  Returns uint8[N, 64]."""
        n = len(val_idx)
        if n == 0:
            return np.zeros((0, 64), dtype=np.uint8)
        out = ed.sign_grouped_templated(*self.sign_args(
            seeds, val_idx, tmpl_idx, templates))
        return out.cpu().numpy()[:n]

    # -- hashing ---------------------------------------------------------
    def leaf_hashes(self, chunks: np.ndarray) -> np.ndarray:
        """Merkle leaf hashes SHA-256(0x00 || chunk) of equal-size chunks
        uint8[n, L] -> uint8[n, 32] (kernel K4)."""
        return merkle.leaf_hashes(self._t(chunks)).cpu().numpy()
