"""Python-integer models of the batch-inverting kernels K2 (comb tables,
`csrc/build_neg_comb.cu`), K3 (grouped signing, `csrc/sign_grouped.cu`)
and K1 (grouped verify, `csrc/verify_grouped.cu`), step for step with
their schedules, against the JAX package's `build_neg_comb_jit`, the
port's plain versions and the golden signer and verifier.

Both kernels invert many Z's with one `fe_invert` per block
(`fe_block_invert` in `csrc/tm_field.cuh`): per warp of 32 lanes an
inclusive prefix and suffix scan of products, the warps' totals, one
inverse, and for each lane the product of everything else.  The JAX
jits run at the shapes the JAX tests already compile (4 keys; 16 lanes x
96-byte templates).
"""

import hashlib
import os
import re
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tendermint_tpu.ops import ed25519 as jed
from tendermint_tpu_torch.crypto import pure_ed25519 as ref
from tendermint_tpu_torch.ops import curve
from tendermint_tpu_torch.ops import ed25519 as ed
from test_torch_verify_raw import decompress   # `ge_decompress`'s model

V, BAD = 4, 2                 # the keyset of tests/test_torch_ed25519.py


@pytest.fixture(autouse=True, scope="module")
def _share_cores():
    """xdist runs several files at once: a worker's share of the cores for
    torch keeps the plain versions' wide tensor ops from oversubscribing
    them."""
    n = torch.get_num_threads()
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def keyset():
    """Four keys, key 2 undecodable, and the JAX reference's tables."""
    seeds = [bytes([90 + i]) * 32 for i in range(V)]
    pubs = np.stack([np.frombuffer(ref.pubkey_from_seed(s), np.uint8)
                     for s in seeds])
    pubs[BAD] = np.frombuffer((2**255 - 1).to_bytes(32, "little"), np.uint8)
    tbl, ok = jed.build_neg_comb_jit(jnp.asarray(pubs))
    return pubs, np.asarray(tbl), np.asarray(ok)


# -- shared: points and the block's batch inversion ----------------------

P, D2 = ref.P, 2 * ref.D % ref.P
IDENT = (0, 1, 1, 0)


def _dbl(p):
    """dbl-2008-hwcd (`ge_dbl`, `quad_dbl`); T is not read."""
    x, y, z, _ = p
    a, b, zz = x * x, y * y, z * z
    e, g = (x + y) ** 2 - a - b, b - a
    f, h = g - 2 * zz, -(a + b)
    return tuple(v % P for v in (e * f, g * h, f * g, e * h))


def _add(p, q):
    """add-2008-hwcd-3 (`ge_add`; `ge_add_cached` forms the same values)."""
    x1, y1, z1, t1 = p
    x2, y2, z2, t2 = q
    a, b = (y1 - x1) * (y2 - x2), (y1 + x1) * (y2 + x2)
    c, d = t1 * t2 * D2, 2 * z1 * z2
    e, f, g, h = b - a, d - c, d + c, b + a
    return tuple(v % P for v in (e * f, g * h, f * g, e * h))


def _warp_products(zs):
    """`fe_warp_products` over 32 lanes: (others, total), from an
    inclusive prefix and suffix scan."""
    pre, suf, d = list(zs), list(zs), 1
    while d < 32:
        pre = [pre[s] * (pre[s - d] if s >= d else 1) % P for s in range(32)]
        suf = [suf[s] * (suf[s + d] if s + d < 32 else 1) % P
               for s in range(32)]
        d *= 2
    others = [(pre[s - 1] if s else 1) * (suf[s + 1] if s < 31 else 1) % P
              for s in range(32)]
    return others, suf[0]


def block_invert(zs):
    """`fe_block_invert` over a block's lanes (a multiple of 32): 1 / z
    per lane with one inversion."""
    warps = [_warp_products(zs[i:i + 32]) for i in range(0, len(zs), 32)]
    totals = [t for _, t in warps]
    rests = []                                   # the other warps' totals
    for k in range(len(warps)):
        rest = 1
        for j, t in enumerate(totals):
            if j != k:
                rest = rest * t % P
        rests.append(rest)
    inv = pow(rests[0] * totals[0] % P, P - 2, P)   # by warp 0
    return [inv * rest * o % P for (others, _), rest in zip(warps, rests)
            for o in others]


# -- K2's schedule (`csrc/build_neg_comb.cu`) --------------------------
#
# Phase 1: decompress, negate, 250 doublings to the 26 window bases P_w.
# Phase 2: one warp per row (w, v), lane s owning digits [32s, 32s + 32):
# its start 32s * P_w from an exclusive Hillis-Steele scan of 32 P_w over
# the 32 lanes, then one add of P_w per digit, staging (X * c, Y * c, Z)
# with c the product of the run's earlier nonzero Z's; four rows (128
# lanes) to a block share one inversion (`fe_block_invert`: per warp a
# prefix and a suffix scan, the warps' totals, one inverse); each lane
# walks its run backwards.  A Z == 0 entry enters the chain as 1, is
# written as zero bytes and clears the key's ok flag.

RUN, ROWS_PER_BLOCK = 32, 4


def comb_bases(pub: bytes):
    """Phase 1: (ok, [P_w for w < 26]), P_w = 2^(10w) (-A)."""
    ok, (x, y, z, t) = decompress(pub)
    p, out = ((-x) % P, y, z, (-t) % P), []
    for _ in range(26):
        out.append(p)
        for _ in range(10):
            p = _dbl(p)
    return ok, out


def lane_starts(p):
    """The 32 lanes' starts 32s * P: 5 doublings, an inclusive scan of the
    lanes' 32 P (each step reading the other lanes' values before it),
    shifted up one lane."""
    q = p
    for _ in range(5):
        q = _dbl(q)
    qs = [q] * 32
    d = 1
    while d < 32:
        qs = [_add(qs[s], qs[s - d] if s >= d else IDENT) for s in range(32)]
        d *= 2
    return [IDENT] + qs[:31]


def stage(points):
    """A lane's forward pass over its run: (staged (X', Y', Z) per entry,
    c = the product of the nonzero Z's, whether a Z was 0)."""
    c, staged, zero = 1, [], False
    for x, y, z, _ in points:
        staged.append((x * c % P, y * c % P, z % P))
        if z % P == 0:
            zero = True
        else:
            c = c * z % P
    return staged, c, zero


def unstage(staged, ic):
    """A lane's backward pass: 96 bytes per entry, (y+x, y-x, 2dxy) or
    zeros where Z == 0."""
    out = [None] * len(staged)
    for r in range(len(staged) - 1, -1, -1):
        xs, ys, z = staged[r]
        if z == 0:
            out[r] = bytes(96)
            continue
        x, y = xs * ic % P, ys * ic % P
        ic = ic * z % P
        out[r] = b"".join(v.to_bytes(32, "little") for v in (
            (y + x) % P, (y - x) % P, x * y * D2 % P))
    return out


def model_build_neg_comb(pubs):
    """K2 on uint8[V, 32] keys -> (uint8[26, 1024, V, 3, 32], ok[V])."""
    nv = len(pubs)
    oks, bases = zip(*(comb_bases(p.tobytes()) for p in pubs))
    oks = list(oks)
    tbl = np.zeros((26, 1024, nv, 96), np.uint8)
    nrows = 26 * nv
    for b0 in range(0, nrows, ROWS_PER_BLOCK):
        lanes = []                              # (row, lane, staged)
        cs = []
        for row in range(b0, b0 + ROWS_PER_BLOCK):
            if row >= nrows:                    # a warp past the last row
                cs += [1] * 32
                continue
            w, v = divmod(row, nv)
            p = bases[v][w]
            for s, start in enumerate(lane_starts(p)):
                pts, acc = [], start
                for r in range(RUN):
                    if r:
                        acc = _add(acc, p)
                    pts.append(acc)
                staged, c, zero = stage(pts)
                if zero:
                    oks[v] = False
                lanes.append((row, s, staged))
                cs.append(c)
        ics = block_invert(cs)
        for i, (row, s, staged) in enumerate(lanes):
            w, v = divmod(row, nv)
            slot = (row - b0) * 32 + s
            for r, e in enumerate(unstage(staged, ics[slot])):
                tbl[w, RUN * s + r, v] = np.frombuffer(e, np.uint8)
    return tbl.reshape(26, 1024, nv, 3, 32), np.array(oks)


def test_comb_row_schedule_model_matches_reference(keyset):
    """The model of K2's schedule on the keyset (one undecodable key)
    gives the JAX reference's table bytes for every valid key, its ok
    mask, and the port's plain tables."""
    pubs, jtbl, jok = keyset
    tbl, ok = model_build_neg_comb(pubs)
    assert ok.tolist() == jok.tolist() == [i != BAD for i in range(V)]
    assert np.array_equal(tbl[:, :, jok], jtbl[:, :, jok])


def test_comb_lane_starts_are_multiples():
    """The scanned starts are 32s * P as group elements."""
    p = ref.pt_mul(987654321, ref.BASE)
    for s, start in enumerate(lane_starts(p)):
        assert ref.pt_eq(start, ref.pt_mul(32 * s, p) if s else IDENT)


def test_comb_batch_inversion_masks_a_zero_z():
    """A run holding a Z == 0 entry: that entry's bytes are zero, the
    lane's c skips it, and every other entry of the block (this lane's
    and the other 127 lanes') still packs to its canonical affine bytes."""
    rng = np.random.default_rng(23)
    runs = []
    for lane in range(128):
        pts = []
        for r in range(RUN):
            q = ref.pt_mul(int(rng.integers(1, 2**62)), ref.BASE)
            k = int.from_bytes(rng.bytes(32), "little") % (P - 1) + 1
            pts.append(tuple(v * k % P for v in q))
        runs.append(pts)
    runs[37][5] = (123, 456, 0, 789)                # Z == 0
    runs[37][6] = (11, 22, P, 33)                   # Z == p: zero as well
    staged, cs, zero = zip(*(stage(pts) for pts in runs))
    assert [i for i, z in enumerate(zero) if z] == [37]
    ics = block_invert(list(cs))
    for lane, pts in enumerate(runs):
        got = unstage(staged[lane], ics[lane])
        for r, (x, y, z, _) in enumerate(pts):
            if z % P == 0:
                assert got[r] == bytes(96)
                continue
            zi = pow(z, P - 2, P)
            ax, ay = x * zi % P, y * zi % P
            assert got[r] == b"".join(v.to_bytes(32, "little") for v in (
                (ay + ax) % P, (ay - ax) % P, ax * ay * D2 % P))


# -- K3's lane (`csrc/sign_grouped.cu`) -----------------------------------
#
# Per lane: r = SHA-512(prefix || M) mod L and [r]B by 22 mixed adds from
# the port's 12-bit base table; a lane without a key or a message, and a
# lane past N in the last block, holds the identity (Z = 1).  Each block
# of 128 lanes inverts its Z's with one inversion; then R is encoded, k =
# SHA-512(R || A || M) mod L and S = (r + k a) mod L.  A lane with an
# index out of range signs nothing: 64 zero bytes.

SIGN_BLOCK = 128


def _madd(p, e):
    """`ge_add_aff`: P + a base entry (y+x, y-x, 2dxy)."""
    x1, y1, z1, t1 = p
    ypx, ymx, xy2d = e
    a, b = (y1 - x1) * ymx, (y1 + x1) * ypx
    c, d = t1 * xy2d, 2 * z1
    e_, f, g, h = b - a, d - c, d + c, b + a
    return tuple(v % P for v in (e_ * f, g * h, f * g, e_ * h))


def _base_entry(base, w, d):
    return tuple(int.from_bytes(base[w, d, i].tobytes(), "little")
                 for i in range(3))


def _sha_mod_l(*parts) -> int:
    return int.from_bytes(hashlib.sha512(b"".join(parts)).digest(),
                          "little") % ref.L


def model_sign(a, pre, pubs, val_idx, tmpl_idx, templates):
    """K3 over uint8 key rows, int32 lane indices and templates ->
    uint8[N, 64]."""
    base = curve._base_table()
    n = len(val_idx)
    out = np.zeros((n, 64), np.uint8)
    lanes = -(-n // SIGN_BLOCK) * SIGN_BLOCK
    acc, rs, sign = [IDENT] * lanes, [0] * lanes, [False] * lanes
    for i in range(n):
        v, t = int(val_idx[i]), int(tmpl_idx[i])
        sign[i] = 0 <= v < len(a) and 0 <= t < len(templates)
        if not sign[i]:
            continue
        rs[i] = _sha_mod_l(pre[v].tobytes(), templates[t].tobytes())
        p = IDENT
        for w in range(22):
            p = _madd(p, _base_entry(base, w, (rs[i] >> (12 * w)) & 0xfff))
        acc[i] = p
    zi = []
    for b0 in range(0, lanes, SIGN_BLOCK):
        zi += block_invert([p[2] for p in acc[b0:b0 + SIGN_BLOCK]])
    for i in range(n):
        if not sign[i]:
            continue
        v, t = int(val_idx[i]), int(tmpl_idx[i])
        x, y = acc[i][0] * zi[i] % P, acc[i][1] * zi[i] % P
        R = (y | (x & 1) << 255).to_bytes(32, "little")
        k = _sha_mod_l(R, pubs[v].tobytes(), templates[t].tobytes())
        s = (rs[i] + k * int.from_bytes(a[v].tobytes(), "little")) % ref.L
        out[i] = np.frombuffer(R + s.to_bytes(32, "little"), np.uint8)
    return out


def _signing_keys(seeds):
    mats = np.zeros((3, len(seeds), 32), np.uint8)
    for i, s in enumerate(seeds):
        for m, part in zip(mats, ref.expand_seed(s)):
            m[i] = np.frombuffer(part, np.uint8)
    return mats


@pytest.mark.parametrize("n", [1, 31, 33, 129])
def test_sign_batch_inversion_model(n):
    """Ragged batches (a partial warp, a partial second warp, a second
    block) with lanes whose key or template index is out of range mixed
    into the warps: the model's signatures are `pure_ed25519.sign`'s, and
    zeros on the lanes that sign nothing; the plain signer's, every lane
    (it masks out-of-range lanes to zeros too)."""
    rng = np.random.default_rng(50 + n)
    seeds = [bytes([60 + i]) * 32 for i in range(5)]
    a, pre, pubs = _signing_keys(seeds)
    templates = rng.integers(0, 256, (6, 96), dtype=np.uint8)
    vi = rng.integers(0, 5, n).astype(np.int32)
    ti = rng.integers(0, 6, n).astype(np.int32)
    if n > 1:
        vi[rng.random(n) < 0.2] = 5                 # one past the keys
        ti[rng.random(n) < 0.15] = -1
    got = model_sign(a, pre, pubs, vi, ti, templates)
    valid = (vi >= 0) & (vi < 5) & (ti >= 0) & (ti < 6)
    assert (n == 1 or (~valid).any()) and valid.any()
    assert not got[~valid].any()
    for i in np.flatnonzero(valid):
        assert got[i].tobytes() == ref.sign(seeds[vi[i]],
                                            templates[ti[i]].tobytes())
    plain = ed.sign_grouped_templated_plain(
        *(torch.as_tensor(x) for x in (a, pre, pubs, vi, ti, templates)),
        ed.base_table("cpu")).numpy()
    assert np.array_equal(got, plain)


def test_sign_model_matches_jax_signer():
    """The JAX package's signing test's inputs (4 keys, 16 lanes, 4
    templates of 96 bytes): model == `sign_grouped_templated_jit`."""
    seeds = [bytes([40 + i]) * 32 for i in range(4)]
    mats = _signing_keys(seeds)
    rng = np.random.default_rng(8)
    templates = rng.integers(0, 256, (4, 96), dtype=np.uint8)
    val_idx = (np.arange(16) % 4).astype(np.int32)
    tmpl_idx = ((np.arange(16) * 7) % 4).astype(np.int32)
    want = np.asarray(jed.sign_grouped_templated_jit(
        *(jnp.asarray(x) for x in (*mats, val_idx, tmpl_idx, templates))))
    assert np.array_equal(model_sign(*mats, val_idx, tmpl_idx, templates),
                          want)


# -- K1's lane (`csrc/verify_grouped.cu`) -----------------------------------
#
# One thread per lane, VERIFY_BLOCK lanes to a block: a lane whose indices
# are in range hashes k = SHA-512(R || A || M) mod L, runs [s]B by 22 mixed
# adds from the base table and [k](-A) by 26 from its key's comb column,
# and adds the two; a lane past N or with an index out of range computes
# nothing and holds the identity.  Each block inverts its Z's with one
# inversion, a Z == 0 entering as 1; then the lane encodes, compares with
# R byte for byte and is masked by pub_ok, s < L, Z != 0 and its indices.

VERIFY_BLOCK = int(re.search(
    r"#define VERIFY_BLOCK (\d+)",
    (Path(ed.__file__).parent.parent / "csrc" /
     "verify_grouped.cu").read_text()).group(1))


def _comb_entry(tbl, w, d, v):
    return tuple(int.from_bytes(tbl[w, d, v, i].tobytes(), "little")
                 for i in range(3))


def model_verify_grouped(tbl, pub_ok, pubs, pub_idx, val_idx, templates,
                         tmpl_idx, sigs, block=VERIFY_BLOCK, zero_z=()):
    """K1 over numpy arguments (the kernel's, `pub_idx` rows of `pubs`)
    -> bool[N].  `zero_z`: lanes whose sum is replaced by a point with
    Z == 0, as a forged table column can make it."""
    base = curve._base_table()
    n, vb = len(val_idx), tbl.shape[2]
    lanes = -(-n // block) * block
    pts, ok, inside = [IDENT] * lanes, [False] * lanes, [False] * lanes
    for i in range(n):
        v, pi, ti = int(val_idx[i]), int(pub_idx[i]), int(tmpl_idx[i])
        inside[i] = (0 <= v < vb and 0 <= pi < len(pubs)
                     and 0 <= ti < len(templates))
        if not inside[i]:
            continue
        sig = sigs[i].tobytes()
        k = _sha_mod_l(sig[:32], pubs[pi].tobytes(), templates[ti].tobytes())
        s = int.from_bytes(sig[32:], "little")
        ok[i] = bool(pub_ok[v]) and s < ref.L
        sb = ka = IDENT
        for w in range(22):
            sb = _madd(sb, _base_entry(base, w, (s >> (12 * w)) & 0xfff))
        for w in range(26):
            ka = _madd(ka, _comb_entry(tbl, w, (k >> (10 * w)) & 0x3ff, v))
        pts[i] = _add(sb, ka)
    for i in zero_z:
        pts[i] = (pts[i][0], pts[i][1], 0, pts[i][3])
    nz = [p[2] % P != 0 for p in pts]
    zi = []
    for b0 in range(0, lanes, block):
        zi += block_invert([p[2] if z else 1
                            for p, z in zip(pts[b0:b0 + block],
                                            nz[b0:b0 + block])])
    out = []
    for i in range(n):
        x, y = pts[i][0] * zi[i] % P, pts[i][1] * zi[i] % P
        enc = (y | (x & 1) << 255).to_bytes(32, "little")
        out.append(inside[i] and ok[i] and nz[i] and
                   enc == sigs[i, :32].tobytes())
    return np.array(out)


def _verify_lanes(seeds, templates, n, rng):
    """n templated lanes over the keyset: valid ones, s + L, R >= p, a
    flipped R bit, a wrong key, R = identity, and key and template indices
    of -1 and the count."""
    vi = rng.integers(0, V, n).astype(np.int32)
    ti = rng.integers(0, len(templates), n).astype(np.int32)
    sigs = np.zeros((n, 64), np.uint8)
    for i in range(n):
        sig = ref.sign(seeds[vi[i]], templates[ti[i]].tobytes())
        kind = i % 10
        if kind == 1:
            s = int.from_bytes(sig[32:], "little") + ref.L
            sig = sig[:32] + s.to_bytes(32, "little")
        elif kind == 2:
            sig = P.to_bytes(32, "little") + sig[32:]
        elif kind == 3:
            sig = bytes([sig[0] ^ 4]) + sig[1:]
        elif kind == 4:
            sig = ref.sign(seeds[(vi[i] + 1) % V], templates[ti[i]].tobytes())
        elif kind == 5:
            sig = (1).to_bytes(32, "little") + bytes(32)
        elif kind == 6:
            vi[i] = -1 if i % 20 == 6 else V
        elif kind == 7:
            ti[i] = -1 if i % 20 == 7 else len(templates)
        sigs[i] = np.frombuffer(sig, np.uint8)
    return vi, ti, sigs


@pytest.mark.parametrize("block", [32, VERIFY_BLOCK])
def test_verify_block_inversion_model(keyset, block):
    """The model of K1's schedule on 40 lanes (blocks of 32, or one of the
    kernel's blocks with its lanes past N), with out-of-range lanes mixed
    in and one valid lane forged to Z == 0: its verdict is False and every
    other lane's is the plain version's and the golden verifier's, so the
    zero cannot poison the block's inversion."""
    pubs, jtbl, jok = keyset
    seeds = [bytes([90 + i]) * 32 for i in range(V)]
    rng = np.random.default_rng(61)
    templates = rng.integers(0, 256, (5, 96), dtype=np.uint8)
    n = 40
    vi, ti, sigs = _verify_lanes(seeds, templates, n, rng)
    t = torch.as_tensor
    plain = ed.verify_grouped_templated_plain(
        t(jtbl), t(jok), t(pubs), t(vi), t(ti), t(templates), t(sigs),
        ed.base_table("cpu")).numpy()
    golden = [0 <= vi[i] < V and vi[i] != BAD and 0 <= ti[i] < 5 and
              ref.verify(pubs[vi[i]].tobytes(), templates[ti[i]].tobytes(),
                         sigs[i].tobytes()) for i in range(n)]
    assert plain.tolist() == golden
    forged = int(np.flatnonzero(plain)[1])
    got = model_verify_grouped(jtbl, jok, pubs, vi, vi, templates, ti, sigs,
                               block, zero_z=(forged,))
    want = plain.copy()
    want[forged] = False
    assert got.tolist() == want.tolist()
    assert int(got.sum()) >= 6
    # the same zero entering the inversion as itself zeroes every inverse
    assert set(block_invert([5] * 31 + [0])) == {0}
