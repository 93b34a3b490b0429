"""The CUDA kernels' mod-L reduction (`csrc/tm_scalar.cuh`
`sc_reduce_words`: Barrett on 64-bit words) as a word-level Python model,
step for step with the source — the same constants, the same rows of
64 x 64 -> 128-bit products (`__umul64hi` for the high half), the same
carries, borrows and two conditional subtractions — against Python's
`% L`, at its edges, and against the JAX package's `scalar.reduce512` /
`muladd_mod_L` on the shapes the JAX tests already compile.
"""

import re
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
from hypothesis import given, settings, strategies as st

from tendermint_tpu.ops import scalar as jsc

L = 2**252 + 27742317777372353535851937790883648493
M64 = (1 << 64) - 1
SRC = (Path(__file__).resolve().parents[1] / "tendermint_tpu_torch" / "csrc"
       / "tm_scalar.cuh").read_text()


def _const(name: str) -> int:
    return int(re.search(rf"#define {name} (0x[0-9a-f]+)ULL", SRC).group(1),
               16)


MU = [_const(f"SC_MU{i}") for i in range(5)]
LW = [_const(f"SC_L{i}") for i in range(4)] + [0]


def mac_row(t: list, k: int, a: int, b: list, n: int) -> None:
    """`sc_mac_row(t + k, a, b, n)`: t[k..] += a * b[0..n), the carry out
    stored in t[k + n]."""
    carry = 0
    for j in range(n):
        lo = (a * b[j]) & M64
        hi = (a * b[j]) >> 64                   # __umul64hi
        s = (t[k + j] + lo) & M64
        hi += s < lo
        s2 = (s + carry) & M64
        hi += s2 < carry
        assert hi <= M64                        # a 64-bit carry never wraps
        t[k + j] = s2
        carry = hi
    t[k + n] = carry


def sub5(a: list, b: list) -> None:
    """`sc_sub5`: a -= b over five words, mod 2^320."""
    borrow = 0
    for i in range(5):
        d = (a[i] - b[i] - borrow) & M64
        borrow = int(a[i] < b[i] or (a[i] == b[i] and borrow))
        a[i] = d


def reduce_words(w: list) -> list:
    """`sc_reduce_words`: eight little-endian words -> four words of
    w mod L."""
    q2 = [0] * 10
    for i in range(5):
        mac_row(q2, i, w[3 + i], MU, 5)
    m = [0] * 6
    for i in range(5):
        mac_row(m, i, q2[5 + i], LW, 5 - i)
    x = list(w[:5])
    sub5(x, m)
    for _ in range(2):
        y = list(x)
        sub5(y, LW)
        if y[4] >> 63 == 0:                      # x - L >= 0
            x = y
    assert x[4] == 0
    return x[:4]


def words(v: int, n: int) -> list:
    return [(v >> (64 * i)) & M64 for i in range(n)]


def value(ws: list) -> int:
    return sum(x << (64 * i) for i, x in enumerate(ws))


def reduce_int(v: int) -> int:
    return value(reduce_words(words(v, 8)))


def muladd(k: int, a: int, r: int) -> int:
    """`sc_muladd`: the 4 x 4-word schoolbook product k * a, r added with
    a carry chain over eight words, then `sc_reduce_words`."""
    kw, aw, rw = words(k, 4), words(a, 4), words(r, 4)
    t = [0] * 9
    for i in range(4):
        mac_row(t, i, kw[i], aw, 4)
    c = 0
    for i in range(8):
        add = rw[i] if i < 4 else 0
        s = (t[i] + add) & M64
        c1 = int(s < add)
        s2 = (s + c) & M64
        c1 += s2 < c
        t[i] = s2
        c = c1
    assert c == 0                               # k * a + r < 2^512
    return value(reduce_words(t[:8]))


def test_constants_are_floor_2_512_over_L():
    assert value(MU) == (1 << 512) // L
    assert value(LW) == L


MULADD_MAX = (L - 1) * (2**255 - 1) + (L - 1)   # k < L, a < 2^255, r < L


@pytest.mark.parametrize("v", [
    0, 1, L - 1, L, L + 1, 2 * L, 3 * L - 1, 2**252, 2**252 - 1,
    2**256 - 1, 2**512 - 1, (2**512 // L) * L, (2**512 // L) * L - 1,
    MULADD_MAX, L * L, 2**256 * L - 1])
def test_fold_edges(v):
    assert reduce_int(v) == v % L


@settings(max_examples=2000, derandomize=True, database=None, deadline=None)
@given(st.integers(min_value=0, max_value=2**512 - 1))
def test_fold_matches_python_mod(v):
    assert reduce_int(v) == v % L


@settings(max_examples=500, derandomize=True, database=None, deadline=None)
@given(st.integers(min_value=0, max_value=L - 1),
       st.integers(min_value=0, max_value=2**255 - 1),
       st.integers(min_value=0, max_value=L - 1))
def test_muladd_matches_python(k, a, r):
    assert MULADD_MAX < 2**509
    assert muladd(k, a, r) == (r + k * a) % L


@pytest.mark.parametrize("q", [1, 2, 3, 2**200, 2**259])
def test_fold_near_multiples_of_L(q):
    """Values a few units either side of q * L, where Barrett's quotient
    estimate is tightest."""
    for d in (-2, -1, 0, 1, 2):
        v = q * L + d
        if 0 <= v < 2**512:
            assert reduce_int(v) == v % L


def test_fold_matches_jax_reduce512():
    """On `tests/test_ed25519.py`'s shape (32 digests), edges first."""
    rng = np.random.default_rng(1)
    h = rng.integers(0, 256, (32, 64), dtype=np.uint8)
    for i, v in enumerate([0, L - 1, L, 2**512 - 1, 2**252, MULADD_MAX]):
        h[i] = np.frombuffer(v.to_bytes(64, "little"), np.uint8)
    want = np.asarray(jsc.reduce512(jnp.asarray(h)))
    for row, lim in zip(h, want):
        got = reduce_int(int.from_bytes(row.tobytes(), "little"))
        assert got == jsc.limbs_to_int(lim)


def test_muladd_matches_jax():
    """On `tests/test_ed25519.py`'s shape (16 lanes of k, a, r), the top
    lanes at the domain's limits."""
    rng = np.random.default_rng(7)
    k, a, r = (rng.integers(0, 256, (16, 32), dtype=np.uint8)
               for _ in range(3))
    k[:, 31] &= 0x0F
    r[:, 31] &= 0x0F
    a[:, 31] &= 0x7F
    for arr, top in ((k, L - 1), (a, 2**255 - 1), (r, L - 1)):
        arr[0] = np.frombuffer(top.to_bytes(32, "little"), np.uint8)
    want = np.asarray(jsc.muladd_mod_L(jnp.asarray(k), jnp.asarray(a),
                                       jnp.asarray(r)))
    for ki, ai, ri, wi in zip(k, a, r, want):
        ki_, ai_, ri_ = (int.from_bytes(x.tobytes(), "little")
                         for x in (ki, ai, ri))
        assert muladd(ki_, ai_, ri_) == jsc.limbs_to_int(wi)
