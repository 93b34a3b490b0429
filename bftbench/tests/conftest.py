"""Tests of the benchmark's harness.  Run from the repository's root:

    python -m pytest bftbench/tests -q              # on the CPU
    python -m pytest bftbench/tests -q -m card      # on the card

Tests marked `card` need a CUDA device and skip without one; whether
there is one is decided inside the `card` fixture, never at import."""

import sys
from pathlib import Path

import numpy as np
import pytest

CHECKOUT = Path(__file__).resolve().parents[2]
if str(CHECKOUT) not in sys.path:
    sys.path.insert(0, str(CHECKOUT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device (skips without one)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")


def ref_signer(seeds, val_idx, tmpl_idx, templates):
    """The reference's ed25519 as the inputs' signer, for CPU runs."""
    from bftbench.reference import ed25519
    return np.stack([np.frombuffer(ed25519.sign(
        seeds[v], templates[i].tobytes()), np.uint8)
        for v, i in zip(val_idx, tmpl_idx)])


# the cells at sizes a CPU test holds: every path and check, few lanes
TINY = {
    "fastsync.v100.load1k": {"config": {"validators": 4, "window": 3},
                             "traffic": {"txs_per_block": 3, "tx_bytes": 40,
                                         "blocks": 6, "tip_blocks": 2}},
    "light.v100.c8": {"config": {"validators": 4, "chains": 3},
                      "traffic": {"headers_per_call": 6}},
}


def tiny_run(cell, seed=2**33 + 5, seconds=0.6, trace=False,
             backend=None, bench=None, overrides=None):
    """One run of `cell` on the CPU at its TINY size, on the program's
    golden backend (or `backend()`), signed by the reference."""
    import time
    from bftbench import harness
    from tendermint_tpu_torch.crypto.backend import PythonBackend
    make = backend or PythonBackend
    return harness.run(cell, seed, seconds, trace,
                       t_start=time.perf_counter(), device="cpu",
                       backend_factory=lambda _d: make(), signer=ref_signer,
                       bench=bench, overrides=overrides or TINY[cell])
