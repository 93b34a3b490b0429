"""Out-of-process crypto-plane warmer.

Copy of `tendermint_tpu/crypto/warmcompile.py` for the hand-written
kernels.  The JAX warmer compiles XLA executables into a persistent
cache; here nothing compiles per shape: the one compile is the kernel
library (`ops/kernels.library()`: nvcc into `build/kernels/`, once per
source tree), which this process builds, or finds built and loads.  It
then launches each spec's shape once through `CudaBackend`: K2 for the
spec's key set and K1 (the "templated" and "plain" routes), or K3
("sign").  A later process of the same tree loads the library in place
of building it; no process-wide or environment state is read.

Usage: python -m tendermint_tpu_torch.crypto.warmcompile '<json-spec>'
spec: one spec object or a LIST of them, each
  {"kind": "templated"|"plain"|"sign", ...}
  templated: {"vb": int, "shape": [b, tb, mlen]}
  plain:     {"vb": int, "shape": [b, mlen]}
  sign:      {"v": int, "shape": [b, tb, mlen]}   # v keys, EXACT
  optional:  "device" (default "cuda"; "cpu" runs the plain versions)

One stdout JSON line per spec ({"kind", "compile_seconds"}; the first
spec's interval holds the library's build or load), plus
"launch_seconds", "launches" (the spec's kernel launches by kernel, from
`ops/kernels.LAUNCHES`; none on the CPU) and "digest": the SHA-256 of
the spec's outputs (K2's mask and the tables of the keys it marks valid,
K2's contract, then K1's mask or K3's signatures), so a caller can hold
the launches against the plain versions on the same inputs
(`spec_inputs`).  The JAX spec's
"cache_dir" (the XLA cache) has no counterpart and is ignored.
"""

from __future__ import annotations

import hashlib
import json
import sys
import time

import numpy as np


def _bucket(n: int) -> int:
    # mirrors crypto.backend._bucket without importing its module tree
    b = 16
    while b < n:
        b *= 2
    return b


def bench_config3_specs(n_vals: int, n_blocks: int, window: int,
                        target_lanes: int) -> list[dict]:
    """The device shapes bench config 3 hits at full scale: the window's
    templated verify bucket and the fixture signer's sign-chunk bucket
    (655 template rows a sign call).  Derived from the run parameters,
    the same shapes as the JAX function's for the same arguments."""
    from tendermint_tpu_torch.types.canonical import SIGN_BYTES_LEN
    window = max(1, min(n_blocks, window or (target_lanes // n_vals)))
    sign_tmpls = min(655, n_blocks)
    return [
        {"kind": "templated", "vb": _bucket(n_vals),
         "shape": [_bucket(window * n_vals), _bucket(window),
                   SIGN_BYTES_LEN]},
        {"kind": "sign", "v": n_vals,
         "shape": [_bucket(sign_tmpls * n_vals), _bucket(sign_tmpls),
                   SIGN_BYTES_LEN]},
    ]


def prewarm(specs: list[dict], wait: bool = False):
    """Spawn the warmer subprocess over `specs`.  wait=False returns the
    Popen at once (the caller overlaps the warm-up with other work);
    wait=True waits for it and raises unless it exited 0.  A failed
    spawn raises (the JAX warmer swallows it)."""
    import subprocess
    proc = subprocess.Popen(
        [sys.executable, "-m", "tendermint_tpu_torch.crypto.warmcompile",
         json.dumps(specs)], stdout=subprocess.PIPE)
    if wait:
        out, _ = proc.communicate(timeout=900)
        if proc.returncode != 0:
            raise subprocess.CalledProcessError(proc.returncode, proc.args,
                                                out)
    return proc


def spec_inputs(spec: dict) -> dict:
    """The spec's inputs, random bytes from a fixed seed: a key set
    (32-byte keys, about half of them no curve point, which K2 marks
    invalid; or signing seeds for "sign"), lane indices, templates,
    signatures."""
    rng = np.random.default_rng(0)
    if spec["kind"] == "sign":
        v = spec["v"]
        b, tb, mlen = spec["shape"]
        return {"seeds": rng.integers(0, 256, (v, 32), np.uint8),
                "val_idx": (np.arange(b) % v).astype(np.int32),
                "tmpl_idx": (np.arange(b) % tb).astype(np.int32),
                "templates": rng.integers(0, 256, (tb, mlen), np.uint8)}
    vb = spec["vb"]
    keys = rng.integers(0, 256, (vb, 32), np.uint8)
    if spec["kind"] == "templated":
        b, tb, mlen = spec["shape"]
        return {"keys": keys,
                "val_idx": (np.arange(b) % vb).astype(np.int32),
                "tmpl_idx": (np.arange(b) % tb).astype(np.int32),
                "templates": rng.integers(0, 256, (tb, mlen), np.uint8),
                "sigs": rng.integers(0, 256, (b, 64), np.uint8)}
    b, mlen = spec["shape"]
    return {"keys": keys, "val_idx": (np.arange(b) % vb).astype(np.int32),
            "msgs": rng.integers(0, 256, (b, mlen), np.uint8),
            "sigs": rng.integers(0, 256, (b, 64), np.uint8)}


def set_key(keys: np.ndarray) -> bytes:
    return hashlib.sha256(b"warmcompile" + keys.tobytes()).digest()


def outputs_digest(*arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def _warm_one(spec: dict, backend) -> tuple:
    """Launch one spec's shape through `backend`: (seconds, digest)."""
    import torch
    t0 = time.perf_counter()
    x = spec_inputs(spec)
    if spec["kind"] == "sign":
        out = (backend.sign_grouped_templated(
            x["seeds"], x["val_idx"], x["tmpl_idx"], x["templates"]),)
    else:
        key = set_key(x["keys"])
        if spec["kind"] == "templated":
            mask = backend.verify_grouped_templated(
                key, x["keys"], x["val_idx"], x["tmpl_idx"],
                x["templates"], x["sigs"])
        else:
            mask = backend.verify_grouped(key, x["keys"], x["val_idx"],
                                          x["msgs"], x["sigs"])
        tbl, ok = backend.tables(key, x["keys"])[:2]
        ok = ok.cpu().numpy()
        # an invalid key's table bytes are not specified (K2's contract)
        out = (ok, tbl.cpu().numpy()[:, :, ok], mask)
    if backend.device.type == "cuda":
        torch.cuda.synchronize(backend.device)
    return time.perf_counter() - t0, outputs_digest(*out)


def main() -> int:
    specs = json.loads(sys.argv[1])
    if isinstance(specs, dict):
        specs = [specs]
    from tendermint_tpu_torch.crypto.backend import CudaBackend
    from tendermint_tpu_torch.ops import kernels
    backends: dict = {}
    for spec in specs:
        dev = spec.get("device", "cuda")
        t0 = time.perf_counter()
        if dev not in backends:
            if dev != "cpu":
                # the kernel library: nvcc on a cold tree, a load after
                kernels.library()
            backends[dev] = CudaBackend(device=dev)
        before = dict(kernels.LAUNCHES)
        secs, digest = _warm_one(spec, backends[dev])
        launched = {k: n - before[k] for k, n in kernels.LAUNCHES.items()
                    if n > before[k]}
        print(json.dumps({"kind": spec["kind"],
                          "compile_seconds": round(
                              time.perf_counter() - t0, 3),
                          "launch_seconds": round(secs, 3),
                          "launches": launched, "digest": digest}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
