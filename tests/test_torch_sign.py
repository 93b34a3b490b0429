"""The port's grouped RFC 8032 signer against the JAX package's jitted
signer and the golden bigint signer.

Same inputs as the JAX package's own signing test (4 keys, 16 lanes, 4
templates of 96 bytes), so the persistent compile cache serves the jit.
On the CPU the K3 wrapper runs its plain PyTorch version.
"""

import os

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from tendermint_tpu.ops import ed25519 as jed
from tendermint_tpu_torch.crypto import pure_ed25519 as ref
from tendermint_tpu_torch.crypto.backend import CudaBackend
from tendermint_tpu_torch.ops import ed25519 as ed

V, N, MSG_LEN = 4, 16, 96


@pytest.fixture(autouse=True, scope="module")
def _share_cores():
    """xdist runs several files at once: a worker's share of the cores for
    torch keeps the plain versions' wide tensor ops from oversubscribing
    them (several torch pools on the same cores run ~20x slower)."""
    n = torch.get_num_threads()
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
    yield
    torch.set_num_threads(n)


def test_sign_grouped_templated_matches_reference():
    seeds = [bytes([40 + i]) * 32 for i in range(V)]
    mats = np.zeros((3, V, 32), np.uint8)
    for i, s in enumerate(seeds):
        for m, part in zip(mats, ref.expand_seed(s)):
            m[i] = np.frombuffer(part, np.uint8)
    rng = np.random.default_rng(8)
    templates = rng.integers(0, 256, (4, MSG_LEN), dtype=np.uint8)
    val_idx = (np.arange(N) % V).astype(np.int32)
    tmpl_idx = ((np.arange(N) * 7) % 4).astype(np.int32)
    want = np.asarray(jed.sign_grouped_templated_jit(
        *(jnp.asarray(x) for x in (*mats, val_idx, tmpl_idx, templates))))
    got = ed.sign_grouped_templated(
        *(torch.as_tensor(x) for x in (*mats, val_idx, tmpl_idx, templates)),
        ed.base_table("cpu")).numpy()
    assert np.array_equal(got, want)
    for i in range(N):
        assert got[i].tobytes() == ref.sign(seeds[val_idx[i]],
                                            templates[tmpl_idx[i]].tobytes())
    be = CudaBackend(device="cpu")
    assert np.array_equal(be.sign_grouped_templated(
        seeds, val_idx[:10], tmpl_idx[:10], templates), got[:10])


def test_sign_index_out_of_range():
    """Lanes whose key index is -1 or V, or whose template index is -1 or
    the template count, sign 64 zero bytes on the plain signer (the K3
    rule); every other lane signs as the reference."""
    seeds = [bytes([40 + i]) * 32 for i in range(V)]
    mats = np.zeros((3, V, 32), np.uint8)
    for i, s in enumerate(seeds):
        for m, part in zip(mats, ref.expand_seed(s)):
            m[i] = np.frombuffer(part, np.uint8)
    rng = np.random.default_rng(8)
    templates = rng.integers(0, 256, (4, MSG_LEN), dtype=np.uint8)
    val_idx = (np.arange(N) % V).astype(np.int32)
    tmpl_idx = ((np.arange(N) * 7) % 4).astype(np.int32)
    want = np.asarray(jed.sign_grouped_templated_jit(
        *(jnp.asarray(x) for x in (*mats, val_idx, tmpl_idx, templates))))
    val_idx[[3, 9]] = [-1, V]
    tmpl_idx[[5, 14]] = [-1, 4]
    got = ed.sign_grouped_templated_plain(
        *(torch.as_tensor(x) for x in (*mats, val_idx, tmpl_idx, templates)),
        ed.base_table("cpu")).numpy()
    out = np.isin(np.arange(N), [3, 5, 9, 14])
    assert not got[out].any()
    assert np.array_equal(got[~out], want[~out])
