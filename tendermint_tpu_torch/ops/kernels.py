"""Build, load and launch the port's hand-written CUDA kernels.

Every `csrc/*.cu` is compiled by its own `nvcc` process (all started
together) for `sm_90a` into an object file, and the objects are linked
into one shared library under `build/kernels/` at the repository root,
named by a digest of the sources and flags so an edit rebuilds and an
unchanged tree reuses it.  The library has a plain C interface loaded
with ctypes: each entry point takes device pointers, int sizes and the
current CUDA stream, and returns `cudaGetLastError()`.

Nothing is built or loaded at import: the first launch on a CUDA tensor
builds, under a `kernel.build` span of the flight recorder (category
`compile`), counted in the `xla_compiles` / `xla_compile_seconds`
metrics.  `LAUNCHES` counts launches per kernel — the one place a launch
happens, under a lock since several threads launch — so a run can show
which kernels its main path went through.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from collections.abc import Sequence
from pathlib import Path

import torch

from tendermint_tpu_torch.utils import tracing
from tendermint_tpu_torch.utils.metrics import REGISTRY

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ["-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# kernel -> (C entry point, argument kinds: p = device pointer, i = int)
_ENTRY = {
    "verify_grouped": ("tm_verify_grouped", "pippipppiippppi"),
    "build_neg_comb": ("tm_build_neg_comb", "pippp"),
    "sign_grouped": ("tm_sign_grouped", "pppipppiippi"),
    "sha256_prefixed": ("tm_sha256_prefixed", "piipi"),
    "verify_raw": ("tm_verify_raw", "ppipppi"),
    "verify_tally": ("tm_verify_tally", "ppippppiippppp"),
    "merkle_roots": ("tm_merkle_roots", "piiipipipi"),
}

LAUNCHES = {name: 0 for name in _ENTRY}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def reset_launches() -> None:
    with _lock:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (PATH or /usr/local/cuda/bin)")
    return path


def _digest(csrc: Path, flags: list, sources: list) -> str:
    h = hashlib.sha256(" ".join([*NVCC_FLAGS, *flags]).encode())
    h.update(" ".join(p.name for p in sources).encode())
    for p in sorted(csrc.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build(csrc: Path = CSRC, flags: Sequence[str] = (),
          only: Sequence[str] | None = None) -> tuple[Path, str]:
    """Compile and link the kernels of the source directory `csrc` (all of
    them, or the kernels named in `only`: kernel `k` is `csrc/k.cu`), with
    `flags` after NVCC_FLAGS, or reuse a build of the same sources and
    flags.  Returns (library path, the compiler's `-Xptxas -v` report, one
    `== <file>.cu` section per source)."""
    csrc, flags = Path(csrc), list(flags)
    sources = (sorted(csrc.glob("*.cu")) if only is None
               else [csrc / f"{k}.cu" for k in only])
    so = BUILD_DIR / f"libtm_kernels-{_digest(csrc, flags, sources)}.so"
    log = so.with_suffix(".log")
    if so.exists() and log.exists():
        return so, log.read_text()
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="build-", dir=BUILD_DIR))
    objs = [work / (src.stem + ".o") for src in sources]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, *flags, "-c", str(src),
                               "-o", str(obj)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(sources, objs)]
    reports = []
    failed = []
    for src, proc in zip(sources, procs):
        out, _ = proc.communicate()
        reports.append(f"== {src.name}\n{out}")
        if proc.returncode != 0:
            failed.append(src.name)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(reports))
    tmp = work / "lib.so"
    link = subprocess.run([nvcc, "-shared", "-o", str(tmp),
                           *map(str, objs)], capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
    report = "\n".join(reports)
    log.write_text(report)
    os.replace(tmp, so)
    shutil.rmtree(work, ignore_errors=True)
    return so, report


def load(so: Path) -> ctypes.CDLL:
    """Load a library from `build`, typing the entry points it has."""
    lib = ctypes.CDLL(str(so))
    for entry, kinds in _ENTRY.values():
        if hasattr(lib, entry):
            fn = getattr(lib, entry)
            fn.argtypes = [ctypes.c_void_p if k == "p" else ctypes.c_int
                           for k in kinds] + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
    return lib


def library() -> ctypes.CDLL:
    """This tree's kernel library, built (or found built) and loaded on
    the first call."""
    global _lib
    with _lock:
        if _lib is None:
            t0 = time.perf_counter()
            with tracing.span("kernel.build"):
                _lib = load(build()[0])
            REGISTRY.xla_compiles.inc()
            REGISTRY.xla_compile_seconds.observe(time.perf_counter() - t0)
    return _lib


@contextlib.contextmanager
def using(lib: ctypes.CDLL):
    """Launch through `lib` (another tree's `load`ed build, with the same C
    entry points) instead of this tree's, inside the block.  For timing
    two builds of a kernel against each other through its wrapper."""
    global _lib
    with _lock:
        saved, _lib = _lib, lib
    try:
        yield lib
    finally:
        with _lock:
            _lib = saved


def check(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int) -> None:
    """Validate a kernel argument: dtype, rank and contiguity."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim}-d, got shape "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def launch(kernel: str, *args) -> None:
    """Launch `kernel` on the current stream.  Tensor arguments pass as
    device pointers and must all lie on one CUDA device; ints as ints."""
    entry, kinds = _ENTRY[kernel]
    if len(args) != len(kinds):
        raise TypeError(f"{kernel}: expected {len(kinds)} args, "
                        f"got {len(args)}")
    device = None
    cargs = []
    for kind, a in zip(kinds, args):
        if kind == "p":
            if a.device.type != "cuda":
                raise ValueError(f"{kernel}: tensor on {a.device}, "
                                 f"expected cuda")
            if device is not None and a.device != device:
                raise ValueError(f"{kernel}: tensors on {device} and "
                                 f"{a.device}")
            device = a.device
            cargs.append(ctypes.c_void_p(a.data_ptr()))
        else:
            cargs.append(ctypes.c_int(int(a)))
    fn = getattr(library(), entry)
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        rc = fn(*cargs, ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed, error {rc}")
    with _lock:
        LAUNCHES[kernel] += 1
