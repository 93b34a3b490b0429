"""The port's raw-lane verify (kernel K5's plain version on the CPU) and
`CudaBackend`'s `verify_batch` / `verify_grouped` against the JAX
package's `ed25519.verify_batch` / `verify_grouped_jit` and the golden
bigint verifier.

The JAX jits run at the shapes the JAX package's own tests compile (16
lanes x 96-byte messages; 4 keys for the grouped tables), so the
persistent compile cache serves them.  Every comparison is exact.
"""

import functools
import hashlib
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tendermint_tpu.ops import curve as jcurve
from tendermint_tpu.ops import ed25519 as jed
from tendermint_tpu.ops import scalar as jsc
from tendermint_tpu_torch.crypto import pure_ed25519 as ref
from tendermint_tpu_torch.crypto.backend import CudaBackend
from tendermint_tpu_torch.ops import curve
from tendermint_tpu_torch.ops import ed25519 as ed
from tendermint_tpu_torch.ops import kernels
from tendermint_tpu_torch.ops import scalar as sc

N, MSG_LEN, V = 16, 96, 4


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


def edge_lanes(msg_len: int, rng) -> list:
    """(pubkey, msg, sig) triples: valid lanes, each single mutation,
    malleated s, non-canonical and undecodable encodings, and the
    cofactorless identity case the golden verifier accepts."""
    seeds = [rng.integers(0, 256, 32, dtype=np.uint8).tobytes()
             for _ in range(4)]
    pubs = [ref.pubkey_from_seed(x) for x in seeds]
    msgs = [rng.integers(0, 256, msg_len, dtype=np.uint8).tobytes()
            for _ in range(4)]
    sigs = [ref.sign(x, m) for x, m in zip(seeds, msgs)]

    def flip(b, i):
        return b[:i] + bytes([b[i] ^ 1]) + b[i + 1:]

    y = 2                                   # smallest y that is no point
    while ref.pt_decode(y.to_bytes(32, "little")) is not None:
        y += 1
    s_big = int.from_bytes(sigs[0][32:], "little") + ref.L
    ident = (1).to_bytes(32, "little")
    return [
        (pubs[0], msgs[0], sigs[0]),                          # valid
        (pubs[1], flip(msgs[1], 0), sigs[1]),                 # message bit
        (pubs[2], msgs[2], flip(sigs[2], 0)),                 # R bit
        (pubs[3], msgs[3], flip(sigs[3], 40)),                # s bit
        (pubs[1], msgs[0], sigs[0]),                          # wrong key
        (pubs[0], msgs[0], sigs[0][:32] + s_big.to_bytes(32, "little")),
        (pubs[1], msgs[1], ref.P.to_bytes(32, "little") + sigs[1][32:]),
        ((ref.P + 3).to_bytes(32, "little"), msgs[2], sigs[2]),  # A y >= p
        (y.to_bytes(32, "little"), msgs[3], sigs[3]),         # A no point
        (ident[:31] + b"\x80", msgs[0], sigs[0]),             # x = 0, sign
        (ident, msgs[1], ident + bytes(32)),                  # identity
        (pubs[2], msgs[2], sigs[2]),                          # valid
    ]


def _arrays(lanes):
    return tuple(np.frombuffer(b"".join(x[k] for x in lanes),
                               np.uint8).reshape(len(lanes), -1).copy()
                 for k in range(3))


def test_verify_batch_matches_reference_on_edge_lanes():
    """16 lanes x 96 B (the edge lanes, then valid repeats): the port's
    plain verify == JAX `verify_batch` == `pure_ed25519.verify`."""
    lanes = edge_lanes(MSG_LEN, np.random.default_rng(31))
    lanes += [lanes[0], lanes[11], lanes[10], lanes[5]]
    pubs, msgs, sigs = _arrays(lanes)
    want = np.asarray(jed.verify_batch(jnp.asarray(pubs), jnp.asarray(msgs),
                                       jnp.asarray(sigs)))
    golden = [ref.verify(*x) for x in lanes]
    kernels.reset_launches()
    t = torch.tensor
    got = ed.verify_batch(t(pubs), t(msgs), t(sigs), ed.base_table("cpu"))
    assert got.tolist() == want.tolist() == golden
    assert golden[:12] == [True] + [False] * 9 + [True, True]
    assert kernels.LAUNCHES["verify_raw"] == 0            # plain on CPU


def test_verify_batch_edge_lanes_32_byte_messages():
    """The mempool's message length (a 32-byte digest): plain == golden."""
    lanes = edge_lanes(32, np.random.default_rng(32))
    pubs, msgs, sigs = _arrays(lanes)
    got = ed.verify_batch(*(torch.tensor(a) for a in (pubs, msgs, sigs)),
                          ed.base_table("cpu"))
    assert got.tolist() == [ref.verify(*x) for x in lanes]


def test_verify_batch_checks_its_arguments():
    base = ed.base_table("cpu")
    z = torch.zeros
    with pytest.raises(ValueError):
        ed.verify_batch(z((2, 31), dtype=torch.uint8),
                        z((2, 32), dtype=torch.uint8),
                        z((2, 64), dtype=torch.uint8), base)
    with pytest.raises(ValueError):
        ed.verify_batch(z((2, 32), dtype=torch.uint8),
                        z((3, 32), dtype=torch.uint8),
                        z((2, 64), dtype=torch.uint8), base)
    with pytest.raises(TypeError):
        ed.verify_batch(z((2, 32), dtype=torch.int32),
                        z((2, 32), dtype=torch.uint8),
                        z((2, 64), dtype=torch.uint8), base)


def test_scalar_helpers_match_reference():
    """`nibbles` and `pt_select` against the JAX package's."""
    rng = np.random.default_rng(33)
    s = rng.integers(0, 256, (3, 32), dtype=np.uint8)
    assert np.array_equal(sc.nibbles(torch.tensor(s)).numpy(),
                          np.asarray(jsc.nibbles(jnp.asarray(s))))
    mask = np.array([True, False, True])
    q = tuple(rng.integers(0, 256, (3, 32)) for _ in range(4))
    r = tuple(rng.integers(0, 256, (3, 32)) for _ in range(4))
    got = curve.pt_select(torch.tensor(mask),
                          tuple(map(torch.tensor, q)),
                          tuple(map(torch.tensor, r)))
    want = jcurve.pt_select(jnp.asarray(mask), tuple(map(jnp.asarray, q)),
                            tuple(map(jnp.asarray, r)))
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("n,msg_len", [(1, 32), (16, 96), (17, 32)])
def test_backend_verify_batch_pads_and_trims(n, msg_len):
    """`CudaBackend(device="cpu").verify_batch` buckets N lanes to a power
    of two by repeating lane 0 and trims the result: every lane agrees
    with the golden verifier."""
    rng = np.random.default_rng(34 + n)
    edge = edge_lanes(msg_len, rng)
    lanes = [edge[(i * 5) % len(edge)] for i in range(n)]
    pubs, msgs, sigs = _arrays(lanes)
    got = CudaBackend(device="cpu").verify_batch(pubs, msgs, sigs)
    assert got.dtype == bool and got.shape == (n,)
    assert got.tolist() == [ref.verify(*x) for x in lanes]


def test_backend_verify_batch_empty():
    z = np.zeros
    out = CudaBackend(device="cpu").verify_batch(
        z((0, 32), np.uint8), z((0, 32), np.uint8), z((0, 64), np.uint8))
    assert out.shape == (0,)


@pytest.fixture(scope="module")
def keyset():
    seeds = [bytes([70 + i]) * 32 for i in range(V)]
    pubs = np.stack([np.frombuffer(ref.pubkey_from_seed(s), np.uint8)
                     for s in seeds])
    tbl, ok = jed.build_neg_comb_jit(jnp.asarray(pubs))
    return seeds, pubs, np.asarray(tbl), np.asarray(ok)


def test_backend_verify_grouped_matches_reference(keyset):
    """12 grouped lanes (valid and adversarial) through
    `CudaBackend.verify_grouped` (bucketed to 16) against JAX
    `verify_grouped_jit` on the same 16 lanes, and the golden verifier."""
    seeds, pubs, jtbl, jok = keyset
    rng = np.random.default_rng(35)
    idx = np.arange(N, dtype=np.int32) % V
    msgs = rng.integers(0, 256, (N, MSG_LEN), dtype=np.uint8)
    sigs = np.stack([np.frombuffer(ref.sign(seeds[v], msgs[i].tobytes()),
                                   np.uint8) for i, v in enumerate(idx)])
    sigs[2, 33] ^= 1                        # s bit
    sigs[5, :32] = np.frombuffer((2**255 - 19).to_bytes(32, "little"),
                                 np.uint8)  # R >= p
    msgs[6, 9] ^= 4                         # message bit
    sigs[9] = sigs[8]                       # another key's signature
    want = np.asarray(jed.verify_grouped_jit(
        jnp.asarray(jtbl), jnp.asarray(jok), jnp.asarray(idx),
        jnp.asarray(pubs[idx]), jnp.asarray(msgs), jnp.asarray(sigs)))
    golden = [ref.verify(pubs[v].tobytes(), msgs[i].tobytes(),
                         sigs[i].tobytes()) for i, v in enumerate(idx)]
    assert want.tolist() == golden
    be = CudaBackend(device="cpu")
    be.tables_from_numpy(b"grouped-set", pubs, jtbl, jok)
    got = be.verify_grouped(b"grouped-set", pubs, idx[:12], msgs[:12],
                            sigs[:12])
    assert got.tolist() == golden[:12]
    assert not got[[2, 5, 6, 9]].any() and got[[0, 1, 3, 4]].all()
    # a set key reused for a set of another size is refused
    with pytest.raises(ValueError, match="different set size"):
        be.verify_grouped(b"grouped-set", pubs[:3], idx[:2] % 3, msgs[:2],
                          sigs[:2])
    with pytest.raises(ValueError, match="out of range"):
        be.verify_grouped(b"grouped-set", pubs, idx + 1, msgs, sigs)


# -- the quad lane schedule of kernels K5 and K6 -------------------------
#
# A Python-integer model of `csrc/tm_verify_raw.cuh`'s `verify_raw_block`:
# four "threads" per signature, thread q holding coordinate q (X, Y, Z, T)
# of every point, operands moved between them as `__shfl_sync` moves them
# (`_shfl`: thread q reads thread src[q]'s value), signed 4-bit windows
# over an 8-entry cached table of -A, and [s]B added by mixed adds from
# the port's base table.

P, D2 = ref.P, 2 * ref.D % ref.P
IDENT4 = [0, 1, 1, 0]
CACHED_IDENT = [1, 1, 2, 0]                 # (Y-X, Y+X, 2Z, 2dT)
XOR1 = [1, 0, 3, 2]


def _shfl(vals, src):
    """What each thread of the quad reads: thread q gets vals[src[q]]."""
    return [vals[src[q]] for q in range(4)]


def _lin(kp, ax, x, ay, y):
    """Per thread q: kp[q] * p + ax[q] * x[q] + ay[q] * y[q] (`fe_lin`)."""
    return [(kp[q] * P + ax[q] * x[q] + ay[q] * y[q]) % P for q in range(4)]


def _mul(a, b):
    return [a[q] * b[q] % P for q in range(4)]


def quad_add(p, c):
    """P + Q, Q cached with thread q holding entry c[q] (`quad_add`):
    A, B, D, C, then E, H, F, G on threads 0-3, each product reading the
    two it needs."""
    o = _shfl(p, XOR1)                            # Y1 on 0, X1 on 1
    a = _lin([2, 0, 0, 0], [-1, 1, 1, 1], p, [1, 1, 0, 0], o)
    m = _mul(a, c)                                # A, B, D, C
    n = _shfl(m, XOR1)                            # B, A, C, D
    v = _lin([2, 0, 2, 0], [-1, 1, 1, 1], m, [1, 1, -1, 1], n)
    return _mul(_shfl(v, [0, 3, 2, 0]), _shfl(v, [2, 1, 3, 1]))


def quad_dbl(p):
    """2P by dbl-2008-hwcd; p[3] (T) is never read (`quad_dbl`):
    X^2, Y^2, Z^2, (X+Y)^2, then G, H, -2Z^2, S on threads 0-3 and
    E = S + H, F = G - 2Z^2."""
    x, y = _shfl(p, [0] * 4), _shfl(p, [1] * 4)
    a = _lin([0] * 4, [1] * 4, [x[3] if q == 3 else p[q] for q in range(4)],
             [0, 0, 0, 1], y)
    m = _mul(a, a)                                # X^2, Y^2, Z^2, S
    n = _shfl(m, XOR1)
    v = _lin([2, 4, 4, 0], [-1, -1, -2, 1], m, [1, -1, 0, 0], n)
    op1 = _lin([0] * 4, [1] * 4, _shfl(v, [3, 0, 0, 3]), [1, 0, 1, 1],
               _shfl(v, [1, 0, 2, 1]))            # E, G, F, E
    op2 = _lin([0] * 4, [1] * 4, _shfl(v, [0, 1, 0, 1]), [1, 0, 0, 0],
               _shfl(v, [2] * 4))                 # F, H, G, H
    return _mul(op1, op2)


def quad_cache(p):
    """P's cached form (Y-X, Y+X, 2Z, 2dT), one entry per thread."""
    o = _shfl(p, XOR1)
    a = _lin([2, 0, 0, 0], [-1, 1, 2, 1], p, [1, 1, 0, 0], o)
    return _mul(a, [1, 1, 1, D2])


def cached_neg(c):
    """-Q cached: threads 0 and 1 swap columns, thread 3 negates."""
    return [c[1], c[0], c[2], -c[3] % P]


def signed_digits(k: int) -> list:
    """64 digits LSB first as the kernel recodes k: nibble + carry of 8 or
    more becomes - 16 and carries one on; the top digit keeps its carry."""
    out, carry = [], 0
    for w in range(64):
        v = ((k >> (4 * w)) & 15) + carry
        carry = 1 if (w < 63 and v >= 8) else 0
        out.append(v - 16 * carry)
    return out


def decompress(b: bytes):
    """`ge_decompress`: (ok, extended point), rejecting y >= p, a
    non-square x^2 and x = 0 with the sign bit; a garbage point when not
    ok."""
    n = int.from_bytes(b, "little")
    sign, y = n >> 255, n & ((1 << 255) - 1)
    ok = y < P
    y %= P
    u, v = (y * y - 1) % P, (ref.D * y * y + 1) % P
    x = u * pow(v, 3, P) * pow(u * pow(v, 7, P), (P - 5) // 8, P) % P
    vx2 = v * x * x % P
    root1, root2 = vx2 == u, vx2 == (-u) % P
    if root2:
        x = x * ref.SQRT_M1 % P
    ok = ok and (root1 or root2) and not (u == 0 and sign == 1)
    if x & 1 != sign:
        x = (-x) % P
    return ok, [x, y, 1, x * y % P]


@functools.lru_cache(maxsize=1)
def _base_entries():
    tbl = curve._base_table().reshape(22, 4096, 3, 32)
    return tbl


def base_entry(w: int, d: int) -> list:
    """Base-table entry (y+x, y-x, 2dxy) as the quad's mixed-add entries
    (y-x, y+x, 2, 2dxy)."""
    ypx, ymx, xy2d = (int.from_bytes(_base_entries()[w, d, i].tobytes(),
                                     "little") for i in range(3))
    return [ymx, ypx, 2, xy2d]


def model_verify(pub: bytes, msg: bytes, sig: bytes) -> bool:
    """One lane of `verify_raw_block`, step by step: the per-lane phase
    (k and its digits, s < L, A and R decompressed), then its quad."""
    k = int.from_bytes(hashlib.sha512(sig[:32] + pub + msg).digest(),
                       "little") % ref.L
    digits = signed_digits(k)
    s = int.from_bytes(sig[32:], "little")
    ok_a, A = decompress(pub)
    ok_r, R = decompress(sig[:32])
    na = [-A[0] % P, A[1], 1, -A[3] % P]
    c1 = quad_cache(na)
    table, pj = [c1], na
    for _ in range(7):
        pj = quad_add(pj, c1)
        table.append(quad_cache(pj))
    acc = IDENT4
    for w in range(63, -1, -1):
        if w < 63:
            for _ in range(4):
                acc = quad_dbl(acc)
        d = digits[w]
        entry = CACHED_IDENT if d == 0 else table[abs(d) - 1]
        acc = quad_add(acc, cached_neg(entry) if d < 0 else entry)
    for w in range(22):
        acc = quad_add(acc, base_entry(w, (s >> (12 * w)) & 0xfff))
    z = acc[2]
    eq = (acc[0] == R[0] * z % P and acc[1] == R[1] * z % P and z != 0)
    return ok_a and ok_r and s < ref.L and eq


def _points(rng, n):
    """n points: the identity, small-order points and multiples of B."""
    pts = [tuple(IDENT4)]
    y = 2
    while len(pts) < 4:
        q = ref.pt_decode(y.to_bytes(32, "little"))
        y += 1
        if q is not None:
            pts.append(ref.pt_mul(ref.L, q))     # order dividing 8
    while len(pts) < n:
        pts.append(ref.pt_mul(int(rng.integers(1, 2**62)), ref.BASE))
    return pts


@pytest.mark.parametrize("k", [0, 1, 8, ref.L - 1, 2**253 - 1,
                               int("8" * 63, 16), int("7" * 63, 16),
                               "seeded"])
def test_signed_digits_recombine(k):
    """The recoding of k: digits in [-8, 7] below the top, the top digit
    taking the carry (in [0, 2] for k < 2^253), recombining to k."""
    ks = [k] if k != "seeded" else [
        int.from_bytes(np.random.default_rng(40).integers(
            0, 256, 32, dtype=np.uint8).tobytes(), "little") % ref.L
        for _ in range(64)]
    for k in ks:
        d = signed_digits(k)
        assert all(-8 <= x <= 7 for x in d[:63])
        assert 0 <= d[63] <= 2
        assert sum(x * 16**i for i, x in enumerate(d)) == k


def test_quad_cached_add_is_the_reference_add():
    """The quad's two-step add of a cached entry (2dT multiplied in) gives
    `pure_ed25519.pt_add`'s extended coordinates exactly, on the identity,
    small-order points and multiples of B, and the negated cached entry
    adds -Q."""
    pts = _points(np.random.default_rng(41), 8)
    for p_ in pts:
        for q_ in pts:
            got = quad_add(list(p_), quad_cache(list(q_)))
            assert got == [v % P for v in ref.pt_add(p_, q_)]
            neg = quad_add(list(p_), cached_neg(quad_cache(list(q_))))
            assert ref.pt_eq(tuple(neg), ref.pt_add(p_, ref.pt_neg(q_)))


def test_quad_doubling_without_t():
    """The quad's doubling never reads T: any T gives the same 2P, equal to
    `pure_ed25519.pt_dbl` projectively, with T3 Z3 == X3 Y3."""
    rng = np.random.default_rng(42)
    for p_ in _points(rng, 8):
        want = ref.pt_dbl(p_)
        got = quad_dbl(list(p_))
        assert got == quad_dbl(list(p_[:3]) + [int(rng.integers(0, 2**62))])
        assert ref.pt_eq(tuple(got), want)
        assert got[3] * got[2] % P == got[0] * got[1] % P


def test_quad_steps_are_four_coordinate_updates():
    """Each thread's own table entry c[q] enters the add (the table side
    needs no exchange), and a ladder of 4 doublings and one add per
    signed window computes [k]P as `pure_ed25519.pt_mul`."""
    rng = np.random.default_rng(43)
    p_ = list(ref.pt_mul(12345, ref.BASE))
    c = quad_cache(list(ref.pt_mul(777, ref.BASE)))
    base = quad_add(p_, c)
    for q in range(4):
        c2 = list(c)
        c2[q] = (c2[q] + 1) % P
        changed = quad_add(p_, c2)
        assert changed != base
    k = int(rng.integers(1, 2**62)) * 2**190 + 99
    digits = signed_digits(k)
    table, pj = [quad_cache(p_)], p_
    for _ in range(7):
        pj = quad_add(pj, table[0])
        table.append(quad_cache(pj))
    acc = IDENT4
    for w in range(63, -1, -1):
        for _ in range(4 if w < 63 else 0):
            acc = quad_dbl(acc)
        d = digits[w]
        e = CACHED_IDENT if d == 0 else table[abs(d) - 1]
        acc = quad_add(acc, cached_neg(e) if d < 0 else e)
    assert ref.pt_eq(tuple(acc), ref.pt_mul(k, tuple(p_)))


@pytest.mark.parametrize("msg_len", [32, 96])
def test_quad_lane_model_on_edge_lanes(msg_len):
    """The lane model == `pure_ed25519.verify` == the plain K5 mask on the
    edge lanes (identity, s + L, y >= p, x = 0 with the sign bit, a
    non-square, tampered bits, the wrong key)."""
    lanes = edge_lanes(msg_len, np.random.default_rng(44 + msg_len))
    got = [model_verify(*x) for x in lanes]
    assert got == [ref.verify(*x) for x in lanes]
    plain = ed.verify_batch_plain(*(torch.tensor(a) for a in _arrays(lanes)),
                                  ed.base_table("cpu"))
    assert got == plain.tolist()


def test_quad_lane_model_on_seeded_lanes():
    """64 seeded lanes (numpy seed) with R, s and the message tampered in
    turn, and a small-order key: model == golden == the plain mask."""
    rng = np.random.default_rng(45)
    lanes = []
    for i in range(64):
        seed = rng.integers(0, 256, 32, dtype=np.uint8).tobytes()
        msg = bytearray(rng.integers(0, 256, 32, dtype=np.uint8))
        sig = bytearray(ref.sign(seed, bytes(msg)))
        kind = i % 4
        if kind == 1:
            sig[int(rng.integers(0, 32))] ^= 1 << int(rng.integers(0, 8))
        elif kind == 2:
            sig[32 + int(rng.integers(0, 31))] ^= 1 << int(rng.integers(0, 8))
        elif kind == 3:
            msg[int(rng.integers(0, 32))] ^= 1
        lanes.append((ref.pubkey_from_seed(seed), bytes(msg), bytes(sig)))
    small = ref.pt_encode(_points(rng, 4)[2])
    lanes[-1] = (small, lanes[-1][1], small + bytes(32))
    got = [model_verify(*x) for x in lanes]
    golden = [ref.verify(*x) for x in lanes]
    assert got == golden and 16 <= sum(golden) < 64
    plain = ed.verify_batch_plain(*(torch.tensor(a) for a in _arrays(lanes)),
                                  ed.base_table("cpu"))
    assert got == plain.tolist()
