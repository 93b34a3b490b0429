"""Batched edwards25519 group operations — the plain PyTorch twin of
`tendermint_tpu/ops/curve.py`.

Points are extended coordinates (X, Y, Z, T), each a `field` limb tensor
`[..., 32]`; formulas are add-2008-hwcd-3 / dbl-2008-hwcd for a = -1, as
in the reference.  Python loops take the place of `lax.scan`.  The CUDA
kernels carry the same formulas in `csrc/tm_group.cuh`.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from tendermint_tpu_torch.crypto import pure_ed25519 as ref
from tendermint_tpu_torch.ops import field as fe
from tendermint_tpu_torch.ops import scalar as sc


def _c(x: int, like: torch.Tensor) -> torch.Tensor:
    return fe.const(x, like.device)


def identity(batch_shape=(), device=None) -> tuple:
    z = torch.zeros(tuple(batch_shape) + (fe.NLIMBS,), dtype=torch.int64,
                    device=device)
    o = z.clone()
    o[..., 0] = 1
    return (z, o, o, z)


def pt_add(Q, R):
    """Complete extended addition (add-2008-hwcd-3, a=-1): 9 field muls."""
    x1, y1, z1, t1 = Q
    x2, y2, z2, t2 = R
    a = fe.mul(fe.sub(y1, x1), fe.sub(y2, x2))
    b = fe.mul(fe.add(y1, x1), fe.add(y2, x2))
    c = fe.mul(fe.mul(t1, t2), _c(fe.D2, x1))
    d = fe.mul_small(fe.mul(z1, z2), 2)
    e, f = fe.sub(b, a), fe.sub(d, c)
    g, h = fe.add(d, c), fe.add(b, a)
    return (fe.mul(e, f), fe.mul(g, h), fe.mul(f, g), fe.mul(e, h))


def pt_add_affine(Q, aff):
    """Mixed addition with a precomputed (y+x, y-x, 2d*x*y) entry: 7 muls.
    The (1, 1, 0) entry is the identity."""
    x1, y1, z1, t1 = Q
    yplusx, yminusx, xy2d = aff
    a = fe.mul(fe.sub(y1, x1), yminusx)
    b = fe.mul(fe.add(y1, x1), yplusx)
    c = fe.mul(t1, xy2d)
    d = fe.mul_small(z1, 2)
    e, f = fe.sub(b, a), fe.sub(d, c)
    g, h = fe.add(d, c), fe.add(b, a)
    return (fe.mul(e, f), fe.mul(g, h), fe.mul(f, g), fe.mul(e, h))


def pt_dbl(Q):
    """Dedicated doubling (dbl-2008-hwcd, a=-1): 4 sqr + 4 mul."""
    x1, y1, z1, _ = Q
    a = fe.sqr(x1)
    b = fe.sqr(y1)
    c = fe.mul_small(fe.sqr(z1), 2)
    e = fe.sub(fe.sub(fe.sqr(fe.add(x1, y1)), a), b)
    g = fe.sub(b, a)
    f = fe.sub(g, c)
    h = fe.neg(fe.add(a, b))
    return (fe.mul(e, f), fe.mul(g, h), fe.mul(f, g), fe.mul(e, h))


def pt_neg(Q):
    x, y, z, t = Q
    return (fe.neg(x), y, z, fe.neg(t))


def pt_eq(Q, R) -> torch.Tensor:
    """Projective equality mask: X1*Z2 == X2*Z1 and Y1*Z2 == Y2*Z1."""
    x1, y1, z1, _ = Q
    x2, y2, z2, _ = R
    ex = fe.eq(fe.mul(x1, z2), fe.mul(x2, z1))
    ey = fe.eq(fe.mul(y1, z2), fe.mul(y2, z1))
    return ex & ey


def pt_select(mask, Q, R):
    """Elementwise select: mask[...] ? Q : R."""
    m = mask[..., None]
    return tuple(torch.where(m, q, r) for q, r in zip(Q, R))


def _lt_p(b: torch.Tensor) -> torch.Tensor:
    """Canonical-encoding check: little-endian bytes [..., 32] < p."""
    return sc.lt_const(b, fe._P_LIMBS)


def decompress(b: torch.Tensor) -> tuple:
    """uint8[..., 32] -> (point, ok_mask), matching
    `crypto.pure_ed25519.pt_decode`: rejects y >= p, non-residue x^2, and
    x == 0 with the sign bit set.  Rejected lanes carry garbage points."""
    sign = (b[..., 31] >> 7).to(torch.int64)
    y_bytes = b.clone()
    y_bytes[..., 31] &= 0x7F
    ok = _lt_p(y_bytes)
    y = fe.from_bytes(y_bytes)
    one = _c(1, y)
    y2 = fe.sqr(y)
    u = fe.sub(y2, one)
    v = fe.add(fe.mul(y2, _c(fe.D, y)), one)
    v3 = fe.mul(fe.sqr(v), v)
    v7 = fe.mul(fe.sqr(v3), v)
    x = fe.mul(fe.mul(u, v3), fe.pow22523(fe.mul(u, v7)))
    vx2 = fe.mul(v, fe.sqr(x))
    root1 = fe.eq(vx2, u)
    root2 = fe.eq(vx2, fe.neg(u))
    x = torch.where(root2[..., None], fe.mul(x, _c(fe.SQRT_M1, x)), x)
    ok = ok & (root1 | root2)
    ok = ok & ~(fe.is_zero(u) & (sign == 1))
    flip = fe.parity(x) != sign
    x = torch.where(flip[..., None], fe.neg(x), x)
    return (x, y, one.expand(y.shape), fe.mul(x, y)), ok


def encode_batch(Q) -> tuple:
    """Flat-batched encode: coords [N, 32] -> (uint8[N, 32], Z != 0 mask),
    one Montgomery batch inversion for all lanes."""
    x, y, z, _ = Q
    zi, nz = fe.batch_inv(z)
    xb = fe.parity(fe.mul(x, zi))
    yb = fe.to_bytes(fe.mul(y, zi))
    yb[..., 31] |= (xb << 7).to(torch.uint8)
    return yb, nz


def _build_window_table(Q) -> tuple:
    """Per-lane window tables: T[j] = j*Q for j in [0, 16), coords
    [..., 16, 32], T[0] the identity, by 15 chained adds (reference
    `curve._build_window_table`)."""
    rows = [identity(Q[0].shape[:-1], Q[0].device)]
    for _ in range(15):
        rows.append(pt_add(rows[-1], Q))
    return tuple(torch.stack([r[i] for r in rows], dim=-2) for i in range(4))


def scalar_mul(s: torch.Tensor, Q) -> tuple:
    """[s]Q for s = little-endian bytes/limbs [..., 32]: 4-bit windows
    MSB first, 4 doublings and one table add per window (reference
    `curve.scalar_mul`)."""
    tbl = _build_window_table(Q)
    wins = sc.nibbles(s)
    acc = identity(s.shape[:-1], s.device)
    for w in range(63, -1, -1):
        for _ in range(4):
            acc = pt_dbl(acc)
        idx = wins[..., w, None, None].expand(
            wins.shape[:-1] + (1, fe.NLIMBS))
        acc = pt_add(acc, tuple(torch.gather(t, -2, idx)[..., 0, :]
                                for t in tbl))
    return acc


COMB_WBITS = 10                       # per-validator comb window width
COMB_WINDOWS = -(-256 // COMB_WBITS)  # 26 windows cover 256 bits
COMB_DIGITS = 1 << COMB_WBITS


def _comb_row(Q) -> tuple:
    """Digit rows j*Q for j in [0, 1024), coords [1024, ..., 32]: the row
    doubles in length ten times, row[m:2m] = row[:m] + m*Q with m*Q from
    chained doublings — ten wide adds where the reference's
    `_comb_row0` scans 256 narrow ones (the entries are the same points,
    so their canonical bytes are the same)."""
    row = tuple(c[None] for c in identity(Q[0].shape[:-1], Q[0].device))
    mQ = Q
    for k in range(COMB_WBITS):
        upper = pt_add(row, tuple(c[None] for c in mQ))
        row = tuple(torch.cat([r, u]) for r, u in zip(row, upper))
        if k < COMB_WBITS - 1:
            mQ = pt_dbl(mQ)
    return row


def _affine_pack(row) -> tuple:
    """Extended coords [M, ..., 32] -> packed affine uint8[M, ..., 3, 32]
    (y+x, y-x, 2d*x*y) canonical bytes + per-entry Z != 0 mask, with one
    batch inversion over all entries."""
    x, y, z, _ = row
    shape = z.shape
    zi, nz = fe.batch_inv(z.reshape(-1, fe.NLIMBS))
    zi = zi.reshape(shape)
    xa, ya = fe.mul(x, zi), fe.mul(y, zi)
    packed = torch.stack([
        fe.to_bytes(fe.add(ya, xa)),
        fe.to_bytes(fe.sub(ya, xa)),
        fe.to_bytes(fe.mul(fe.mul(xa, ya), _c(fe.D2, xa))),
    ], dim=-2)
    return packed, nz.reshape(shape[:-1])


def build_affine_comb(Q) -> tuple:
    """Per-point 10-bit comb tables: Q coords [V, 32] -> (packed
    uint8[26, 1024, V, 3, 32], ok bool[V]); entry [w, j, v] is j*2^(10w)*Q_v
    as canonical (y+x, y-x, 2d*x*y) bytes (reference
    `curve.build_affine_comb`).  The window bases 2^(10w)*Q come from
    chained doublings, and all 26 windows' rows are built (`_comb_row`)
    and packed (one batch inversion) together."""
    bases = [Q]
    for _ in range(COMB_WINDOWS - 1):
        P = bases[-1]
        for _ in range(COMB_WBITS):
            P = pt_dbl(P)
        bases.append(P)
    stacked = tuple(torch.stack([b[i] for b in bases]) for i in range(4))
    packed, nz = _affine_pack(_comb_row(stacked))     # [1024, 26, V, ...]
    return packed.transpose(0, 1).contiguous(), nz.all(dim=0).all(dim=0)


_D10_LO = np.array([(COMB_WBITS * w) // 8 for w in range(COMB_WINDOWS)])
_D10_SH = np.array([(COMB_WBITS * w) % 8 for w in range(COMB_WINDOWS)])
_D10_HI = np.minimum(_D10_LO + 1, fe.NLIMBS - 1)
_D10_HI_OK = (_D10_LO + 1 <= fe.NLIMBS - 1).astype(np.int64)


def digits10(s: torch.Tensor) -> torch.Tensor:
    """Bytes/limbs [..., 32] -> 26 little-endian 10-bit digits [..., 26]."""
    x = s.to(torch.int64)
    dev = x.device
    lo = x[..., torch.as_tensor(_D10_LO, device=dev)]
    hi = (x[..., torch.as_tensor(_D10_HI, device=dev)]
          * torch.as_tensor(_D10_HI_OK, device=dev))
    sh = torch.as_tensor(_D10_SH, device=dev)
    return ((lo >> sh) | (hi << (8 - sh))) & (COMB_DIGITS - 1)


def scalar_mul_comb(tbl: torch.Tensor, val_idx: torch.Tensor,
                    s: torch.Tensor) -> tuple:
    """[s] * Q_{val_idx} from packed comb tables uint8[26, 1024, V, 3, 32]:
    26 gathered mixed adds, no doublings."""
    V = tbl.shape[2]
    digits = digits10(s)
    acc = identity(s.shape[:-1], s.device)
    for w in range(COMB_WINDOWS):
        flat = tbl[w].reshape(COMB_DIGITS * V, 3, fe.NLIMBS)
        sel = flat[digits[..., w] * V + val_idx].to(torch.int64)
        acc = pt_add_affine(acc, (sel[..., 0, :], sel[..., 1, :],
                                  sel[..., 2, :]))
    return acc


BASE_WBITS = 12
BASE_WINDOWS = -(-256 // BASE_WBITS)  # 22 windows cover 256 bits


@functools.lru_cache(maxsize=None)
def _base_table() -> np.ndarray:
    """np.uint8[22, 4096, 3, 32]: window w, digit j -> (y+x, y-x, 2d*x*y)
    canonical bytes of j * 2^(12w) * B, built host-side from the golden
    bigint reference with one batch inversion (reference
    `curve._base_table`)."""
    nwin, ndig = BASE_WINDOWS, 1 << BASE_WBITS
    pts = []
    P = ref.BASE
    for _ in range(nwin):
        acc = ref.IDENT
        for _ in range(ndig):
            pts.append(acc)
            acc = ref.pt_add(acc, P)
        P = acc
    prefix, run = [], 1
    for p in pts:
        prefix.append(run)
        run = run * p[2] % ref.P
    run_inv = pow(run, ref.P - 2, ref.P)
    rows = [b""] * len(pts)
    for idx in range(len(pts) - 1, -1, -1):
        x, y, z, _ = pts[idx]
        zi = run_inv * prefix[idx] % ref.P
        run_inv = run_inv * z % ref.P
        xa, ya = x * zi % ref.P, y * zi % ref.P
        rows[idx] = b"".join(v.to_bytes(32, "little") for v in (
            (ya + xa) % ref.P, (ya - xa) % ref.P, 2 * fe.D * xa * ya % ref.P))
    return np.frombuffer(bytearray(b"".join(rows)), np.uint8).reshape(
        nwin, ndig, 3, 32)


_D12_LO = np.array([(12 * w) // 8 for w in range(BASE_WINDOWS)])
_D12_ODD = np.array([(12 * w) % 8 == 4 for w in range(BASE_WINDOWS)])
_D12_HI = np.minimum(_D12_LO + 1, fe.NLIMBS - 1)
_D12_HI_OK = (_D12_LO + 1 <= fe.NLIMBS - 1).astype(np.int64)


def digits12(s: torch.Tensor) -> torch.Tensor:
    """Bytes/limbs [..., 32] -> 22 little-endian 12-bit digits [..., 22]."""
    x = s.to(torch.int64)
    dev = x.device
    lo = x[..., torch.as_tensor(_D12_LO, device=dev)]
    hi = (x[..., torch.as_tensor(_D12_HI, device=dev)]
          * torch.as_tensor(_D12_HI_OK, device=dev))
    even = lo + ((hi & 0xF) << 8)
    odd = (lo >> 4) + (hi << 4)
    return torch.where(torch.as_tensor(_D12_ODD, device=dev), odd, even)


def scalar_mul_base(s: torch.Tensor, tbl: torch.Tensor) -> tuple:
    """[s]B via the 12-bit fixed-base comb (`_base_table()` on the device
    of `s`): 22 mixed adds, zero doublings."""
    digits = digits12(s)
    acc = identity(s.shape[:-1], s.device)
    for w in range(BASE_WINDOWS):
        sel = tbl[w][digits[..., w]].to(torch.int64)
        acc = pt_add_affine(acc, (sel[..., 0, :], sel[..., 1, :],
                                  sel[..., 2, :]))
    return acc
