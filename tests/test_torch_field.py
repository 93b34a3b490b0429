"""The port's field and scalar twins against the JAX package's functions.

`tendermint_tpu_torch.ops.field` / `.scalar` keep the reference's layout
(32 limbs of 8 bits) and its carry passes, so products, sums and
differences must equal the reference's limbs exactly, and every reduced
value its canonical bytes.  Inputs are the edge values of the field and of
the group order plus seeded random values; the JAX side runs as ONE jitted
function so the comparison costs one cached compile.
"""

import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from tendermint_tpu.ops import field as jfe
from tendermint_tpu.ops import scalar as jsc
from tendermint_tpu_torch.ops import field as fe
from tendermint_tpu_torch.ops import scalar as sc

P, L = fe.P, sc.L
EDGES = [0, 1, 19, P - 1, P, P + 1, 2**255 - 1, 2**256 - 1, L - 1, L, L + 1,
         2**252]


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


def _inputs():
    rng = np.random.default_rng(11)
    vals = EDGES + [int.from_bytes(rng.bytes(32), "little") for _ in range(4)]
    a = np.stack([fe.int_to_limbs(v) for v in vals])
    b = a[::-1].copy()
    a[3, :] = 0                       # a zero lane for batch_inv
    digests = np.concatenate([
        np.stack([np.frombuffer(v.to_bytes(64, "little"), np.uint8)
                  for v in (0, L - 1, L, 2**512 - 1, L * L, 2**256 * L - 1)]),
        rng.integers(0, 256, (10, 64), dtype=np.uint8)])
    return a, b, digests


def _reference(a, b, h):
    """Every compared JAX function, in one jit (int32 limbs)."""
    s = a.astype(jnp.uint8)
    zi, nz = jfe.batch_inv(a)
    return {
        "mul": jfe.mul(a, b), "mul_basic": jfe.mul_basic(a, b),
        "add": jfe.add(a, b), "sub": jfe.sub(a, b), "neg": jfe.neg(a),
        "canonical": jfe.canonical(a),
        "inv": jfe.canonical(jfe.inv(b)),
        "pow22523": jfe.canonical(jfe.pow22523(b)),
        "batch_inv": jfe.canonical(zi), "batch_inv_nz": nz,
        "eq": jfe.eq(a, b), "parity": jfe.parity(a),
        "reduce512": jsc.reduce512(h), "lt_L": jsc.lt_L(s),
        "muladd_mod_L": jsc.muladd_mod_L(
            jsc.reduce512(h)[:16].astype(jnp.uint8), s, s),
    }


def test_field_and_scalar_match_reference():
    a, b, h = _inputs()
    want = jax.jit(_reference)(jnp.asarray(a.astype(np.int32)),
                               jnp.asarray(b.astype(np.int32)),
                               jnp.asarray(h))
    want = {k: np.asarray(v) for k, v in want.items()}
    ta, tb, th = torch.as_tensor(a), torch.as_tensor(b), torch.as_tensor(h)
    s = ta.to(torch.uint8)
    zi, nz = fe.batch_inv(ta)
    got = {
        "mul": fe.mul(ta, tb), "mul_basic": fe.mul(ta, tb),
        "add": fe.add(ta, tb), "sub": fe.sub(ta, tb), "neg": fe.neg(ta),
        "canonical": fe.canonical(ta),
        "inv": fe.canonical(fe.inv(tb)),
        "pow22523": fe.canonical(fe.pow22523(tb)),
        "batch_inv": fe.canonical(zi), "batch_inv_nz": nz,
        "eq": fe.eq(ta, tb), "parity": fe.parity(ta),
        "reduce512": sc.reduce512(th), "lt_L": sc.lt_L(s),
        "muladd_mod_L": sc.muladd_mod_L(
            sc.reduce512(th)[:16].to(torch.uint8), s, s),
    }
    for name, w in want.items():
        g = got[name].numpy()
        assert g.shape == w.shape, name
        assert np.array_equal(g.astype(np.int64), w.astype(np.int64)), name
    # zero lanes (0, p, the zeroed lane) invert to 0 and are flagged False
    assert nz.tolist() == [fe.limbs_to_int(r) % P != 0 for r in a]
    assert not fe.canonical(zi)[~nz].any()


def test_field_values_against_bigints():
    """Canonical results are the right residues (independent of JAX)."""
    a, b, h = _inputs()
    ta, tb = torch.as_tensor(a), torch.as_tensor(b)
    va = [fe.limbs_to_int(r) for r in a]
    vb = [fe.limbs_to_int(r) for r in b]
    for got, f in ((fe.mul(ta, tb), lambda x, y: x * y),
                   (fe.sub(ta, tb), lambda x, y: x - y),
                   (fe.inv(tb), lambda x, y: pow(y, P - 2, P))):
        c = fe.canonical(got).numpy()
        assert [fe.limbs_to_int(r) for r in c] == \
            [f(x, y) % P for x, y in zip(va, vb)]
    r = sc.reduce512(torch.as_tensor(h)).numpy()
    assert [sc.limbs_to_int(x) for x in r] == \
        [int.from_bytes(d.tobytes(), "little") % L for d in h]


def test_mul_paths_agree():
    """`mul`'s small-batch outer product and large-batch shifted sums give
    identical limbs."""
    rng = np.random.default_rng(5)
    n = fe._OUTER_MAX // fe.NLIMBS + 3
    a = torch.as_tensor(rng.integers(0, 513, (n, 32)))
    b = torch.as_tensor(rng.integers(0, 513, (n, 32)))
    big = fe.mul(a, b)
    small = torch.cat([fe.mul(a[i:i + 64], b[i:i + 64])
                       for i in range(0, n, 64)])
    assert torch.equal(big, small)
