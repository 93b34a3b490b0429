"""ctypes binding for the port's native host library.

Copy of `tendermint_tpu/utils/nativelib.py` for the port, over two
sources in `tendermint_tpu_torch/native/`: `tmhash.cpp` (batched leaf
hashes and Merkle roots, a copy of `native/tmhash.cpp`) and `ed25519.cpp`
(the crypto ladder's native rung).  They are built together with the host
compiler (`g++`, the one nvcc calls) into one shared library under
`build/native/` at the repository root, named by a digest of the sources
and flags, so an edit rebuilds and an unchanged tree reuses it.  The
library is built in a temporary directory and moved into place with
`os.replace`, so builders in several processes at once each load a whole
file.

Unlike the JAX version, nothing degrades: a failed build or load raises,
and no caller falls back to hashlib.  Nothing is built at import; the
first call builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

SRC_DIR = Path(__file__).resolve().parent.parent / "native"
SOURCES = ("tmhash.cpp", "ed25519.cpp")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ["-O2", "-std=c++17", "-fPIC", "-pthread", "-shared"]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _cxx() -> str:
    path = shutil.which("g++")
    if path is None:
        raise RuntimeError("g++ not found: the native library needs the "
                           "host C++ compiler")
    return path


def _digest() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((SRC_DIR / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile and link the library, or reuse a build of the same sources
    and flags.  Raises RuntimeError when the compiler fails."""
    so = BUILD_DIR / f"libtm_native-{_digest()}.so"
    if so.exists():
        return so
    cxx = _cxx()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="build-", dir=BUILD_DIR))
    try:
        tmp = work / "lib.so"
        r = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp),
                            *(str(SRC_DIR / n) for n in SOURCES)],
                           capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"native build failed:\n{r.stdout}{r.stderr}")
        os.replace(tmp, so)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return so


def load(so: Path) -> ctypes.CDLL:
    """Load a built library and type its entry points."""
    lib = ctypes.CDLL(str(so))
    u8p = ctypes.POINTER(ctypes.c_uint8)
    u64, u32 = ctypes.c_uint64, ctypes.c_uint32
    lib.tm_leaf_hashes.argtypes = [u8p, u64, u64, u8p, u32]
    lib.tm_leaf_hashes.restype = None
    lib.tm_merkle_roots.argtypes = [u8p, u64, u64, u64, u8p, u32]
    lib.tm_merkle_roots.restype = None
    buf = ctypes.c_char_p
    lib.tm_ed25519_pubkey.argtypes = [buf, buf]
    lib.tm_ed25519_sign.argtypes = [buf, buf, u64, buf]
    lib.tm_ed25519_verify.argtypes = [buf, buf, u64, buf]
    for fn in (lib.tm_ed25519_pubkey, lib.tm_ed25519_sign,
               lib.tm_ed25519_verify):
        fn.restype = ctypes.c_int
    lib.tm_ed25519_verify_batch.argtypes = [u8p, u8p, u64, u8p, u64, u8p,
                                            u32]
    lib.tm_ed25519_verify_batch.restype = None
    return lib


def get() -> ctypes.CDLL:
    """The loaded library, building it if needed."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = load(build())
    return _lib


def _threads() -> int:
    return min(16, os.cpu_count() or 1)


def _u8p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def leaf_hashes(msgs: np.ndarray) -> np.ndarray:
    """uint8[N, L] -> 0x00-prefixed sha256 digests uint8[N, 32]."""
    lib = get()
    msgs = np.ascontiguousarray(msgs, dtype=np.uint8)
    n, ln = msgs.shape
    out = np.empty((n, 32), dtype=np.uint8)
    lib.tm_leaf_hashes(_u8p(msgs), n, ln, _u8p(out), _threads())
    return out


def merkle_roots(leaves: np.ndarray) -> np.ndarray:
    """uint8[T, N, L] equal-shape trees -> roots uint8[T, 32]
    (reference-shaped (n+1)//2 split, domain-separated)."""
    lib = get()
    leaves = np.ascontiguousarray(leaves, dtype=np.uint8)
    t, n, ln = leaves.shape
    out = np.empty((t, 32), dtype=np.uint8)
    lib.tm_merkle_roots(_u8p(leaves), t, n, ln, _u8p(out), _threads())
    return out


def ed25519_verify_batch(pubkeys: np.ndarray, msgs: np.ndarray,
                         sigs: np.ndarray, workers: int) -> np.ndarray:
    """uint8 [N,32] keys, [N,M] equal-length messages, [N,64] signatures
    -> bool[N], over `workers` C++ threads (the call releases the GIL)."""
    lib = get()
    pubkeys, msgs, sigs = (np.ascontiguousarray(a, dtype=np.uint8)
                           for a in (pubkeys, msgs, sigs))
    n = len(pubkeys)
    if pubkeys.shape != (n, 32) or sigs.shape != (n, 64) or len(msgs) != n:
        raise ValueError(f"ed25519 lanes: keys {pubkeys.shape}, messages "
                         f"{msgs.shape}, signatures {sigs.shape}")
    out = np.zeros(n, dtype=np.uint8)
    msgs = msgs.reshape(n, -1)
    lib.tm_ed25519_verify_batch(_u8p(pubkeys), _u8p(msgs), msgs.shape[1],
                                _u8p(sigs), n, _u8p(out), workers)
    return out.astype(bool)
