"""Batched GF(2^255-19) arithmetic — the plain PyTorch twin of
`tendermint_tpu/ops/field.py`.

Same layout as the reference: 32 little-endian limbs of 8 bits
(`[..., 32]`), here held in int64.  Same invariant (|limb| <= 512 after
every op), the same parallel carry passes and the same Kogge-Stone
canonicalization, so every function returns the reference's limbs.  The
f32 conv/matmul trick the TPU needed for `mul` becomes an exact integer
schoolbook product.

These twins are the CPU path of the port's kernels and the yardstick the
CUDA kernels (`csrc/tm_field.cuh`, radix 2^25.5) are held against; the
limb choice is invisible to callers, who see canonical bytes and bools.
"""

from __future__ import annotations

import numpy as np
import torch

NLIMBS = 32
RADIX = 8
MASK = (1 << RADIX) - 1

P = 2**255 - 19
D = (-121665 * pow(121666, P - 2, P)) % P
D2 = (2 * D) % P
SQRT_M1 = pow(2, (P - 1) // 4, P)


def int_to_limbs(x: int) -> np.ndarray:
    """Python int (0 <= x < 2^256) -> np.int64[32] little-endian limbs."""
    if not 0 <= x < 2**256:
        raise ValueError("field element out of range")
    return np.array([(x >> (RADIX * i)) & MASK for i in range(NLIMBS)],
                    dtype=np.int64)


def limbs_to_int(limbs) -> int:
    arr = np.asarray(limbs)
    return sum(int(arr[..., i]) << (RADIX * i) for i in range(NLIMBS))


def const(x: int, device=None) -> torch.Tensor:
    return torch.as_tensor(int_to_limbs(x), device=device)


# 8p with small limbs (added before subtraction so values stay >= 0)
_EIGHT_P = np.full(NLIMBS, 255, dtype=np.int64)
_EIGHT_P[0] = 104
_EIGHT_P[31] = 1023
_P_LIMBS = int_to_limbs(P)
# 2^256 - p: the complement for the parallel conditional subtraction
_NEG_P = np.zeros(NLIMBS, dtype=np.int64)
_NEG_P[0] = 19
_NEG_P[31] = 128


def _t(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(a, device=like.device)


def carry(x: torch.Tensor, passes: int = 4) -> torch.Tensor:
    """`passes` rounds of x -> (x & 255) + shift(x >> 8), limb 31's carry
    folded into limb 0 by 38 (reference `field.carry`)."""
    for _ in range(passes):
        c = x >> RADIX
        x = x & MASK
        x[..., 1:] += c[..., :-1]
        x[..., 0] += c[..., -1] * 38
    return x


def add(a, b):
    return carry(a + b, passes=2)


def sub(a, b):
    return carry(a - b + _t(_EIGHT_P, a), passes=2)


def neg(a):
    return carry(_t(_EIGHT_P, a) - a, passes=2)


_OUTER_MAX = 256 * NLIMBS    # lanes x limbs below which `mul` goes outer


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact schoolbook 32x32 limb product, columns 32..62 folded by 38,
    then 4 carry passes — the reference's `mul`/`mul_basic` values with
    integer products in place of the f32 conv.

    The product runs in int32, as the reference's does: under the
    |limb| <= 512 invariant a column is at most 32 * 512^2 < 2^23 and the
    fold by 38 stays below 2^29, so int32 is exact and moves half the
    bytes of int64; the result is widened back to int64."""
    a, b = torch.broadcast_tensors(a, b)
    batch = a.shape[:-1]
    a32, b32 = a.to(torch.int32), b.to(torch.int32)
    if a.numel() <= _OUTER_MAX:
        # small batches: one outer product, columns summed by reading the
        # [32, 64]-padded rows back 63 wide (row i lands shifted by i)
        outer = torch.nn.functional.pad(a32[..., :, None] * b32[..., None, :],
                                        (0, NLIMBS))
        acc = outer.reshape(batch + (2 * NLIMBS * NLIMBS,))[
            ..., :NLIMBS * (2 * NLIMBS - 1)]
        acc = acc.reshape(batch + (NLIMBS, 2 * NLIMBS - 1)).sum(
            dim=-2, dtype=torch.int32)
    else:
        # large batches: 32 shifted multiply-adds over limb-major copies,
        # so every step runs on contiguous rows of lanes
        at = a32.reshape(-1, NLIMBS).T.contiguous()
        bt = b32.reshape(-1, NLIMBS).T.contiguous()
        acc = at.new_zeros((2 * NLIMBS - 1, at.shape[1]))
        for i in range(NLIMBS):
            acc[i:i + NLIMBS].addcmul_(bt, at[i])
        acc = acc.T.reshape(batch + (2 * NLIMBS - 1,))
    lo = acc[..., :NLIMBS] + torch.nn.functional.pad(acc[..., NLIMBS:] * 38,
                                                     (0, 1))
    return carry(lo, passes=4).to(torch.int64)


def sqr(a):
    return mul(a, a)


def mul_small(a, k: int):
    """Multiply by a small constant (normalized a, k <= 4)."""
    if not 1 <= k <= 4:
        raise ValueError("mul_small takes 1 <= k <= 4")
    return carry(a * k, passes=2)


def _sqr_n(z, n: int):
    for _ in range(n):
        z = sqr(z)
    return z


def _pow_2_250_1(z):
    """(z^(2^250 - 1), z^11) by the ref10 addition chain."""
    t0 = sqr(z)                        # 2
    t1 = mul(z, _sqr_n(t0, 2))         # 9
    z11 = mul(t0, t1)                  # 11
    t1 = mul(t1, sqr(z11))             # 2^5 - 1
    t1 = mul(_sqr_n(t1, 5), t1)        # 2^10 - 1
    t2 = mul(_sqr_n(t1, 10), t1)       # 2^20 - 1
    t2 = mul(_sqr_n(t2, 20), t2)       # 2^40 - 1
    t1 = mul(_sqr_n(t2, 10), t1)       # 2^50 - 1
    t2 = mul(_sqr_n(t1, 50), t1)       # 2^100 - 1
    t2 = mul(_sqr_n(t2, 100), t2)      # 2^200 - 1
    return mul(_sqr_n(t2, 50), t1), z11   # 2^250 - 1


def inv(z):
    """z^(p-2) = z^(2^255 - 21) (0 maps to 0): 254 squarings + 11 muls,
    half the reference's square-and-multiply scan, same value."""
    t, z11 = _pow_2_250_1(z)
    return mul(_sqr_n(t, 5), z11)


def pow22523(z):
    """z^((p-5)/8) = z^(2^252 - 3)."""
    t, _ = _pow_2_250_1(z)
    return mul(_sqr_n(t, 2), z)


def _batch_inv_nonzero(z: torch.Tensor) -> torch.Tensor:
    """Blocked Montgomery inversion of NONZERO [N, 32] values (reference
    `field._batch_inv_nonzero`): [K, C] columns, exclusive prefix and
    suffix product sweeps over K, recursion on the C column totals, an
    unrolled chain below 9 lanes."""
    n = z.shape[0]
    one = const(1, z.device)
    if n <= 8:
        pre, acc = [], one
        for i in range(n):
            pre.append(acc)
            acc = mul(acc, z[i]) if i < n - 1 else acc
        suf, acc = [None] * n, one
        for i in range(n - 1, -1, -1):
            suf[i] = acc
            acc = mul(acc, z[i])
        tinv = inv(acc)
        return torch.stack([mul(mul(pre[i], suf[i]), tinv)
                            for i in range(n)])
    # columns: ~sqrt(n) as in the reference, widened so that at most ~128
    # sequential product steps remain (each step is one launch here)
    bits = max(n, 4).bit_length()
    c = 1 << max(bits // 2, bits - 7)
    k = -(-n // c)
    pad = k * c - n
    if pad:
        z = torch.cat([z, one.expand(pad, NLIMBS)])
    cols = z.reshape(k, c, NLIMBS)
    pre, acc = [], one.expand(c, NLIMBS)
    for row in cols:
        pre.append(acc)
        acc = mul(acc, row)
    total = acc
    suf, acc = [None] * k, one.expand(c, NLIMBS)
    for i in range(k - 1, -1, -1):
        suf[i] = acc
        acc = mul(acc, cols[i])
    tinv = _batch_inv_nonzero(total)
    zi = mul(mul(torch.stack(pre), torch.stack(suf)), tinv[None])
    return zi.reshape(k * c, NLIMBS)[:n]


def batch_inv(z: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Montgomery batch inversion over the leading axis: z [N, 32] ->
    (z^-1 [N, 32], nonzero bool[N]).  Zero lanes are masked to 1 inside
    the product chain so they cannot poison it, return 0 and are flagged
    False (reference `field.batch_inv`, `field.py:263-276`)."""
    nz = ~is_zero(z)
    zs = torch.where(nz[..., None], z, const(1, z.device))
    zi = _batch_inv_nonzero(zs)
    return torch.where(nz[..., None], zi, torch.zeros_like(zi)), nz


def _shift_in(x: torch.Tensor, sh: int) -> torch.Tensor:
    """x shifted `sh` limbs toward the top, zeros shifted in."""
    return torch.cat([torch.zeros_like(x[..., :sh]), x[..., :-sh]], dim=-1)


def ks_prefix(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Kogge-Stone scan of the carry-lookahead monoid over the limb axis:
    G[i] = carry OUT of limb i given carry-in 0."""
    n = g.shape[-1]
    G, Pp = g, p
    sh = 1
    while sh < n:
        G = G | (Pp & _shift_in(G, sh))
        Pp = Pp & _shift_in(Pp, sh)
        sh *= 2
    return G


def ks_normalize(x: torch.Tensor):
    """Exact byte normalization of limbs in [0, 510]: (bytes, carry_out)."""
    G = ks_prefix(x >= 256, x >= 255)
    r = (x + _shift_in(G, 1).to(x.dtype)) & MASK
    return r, G[..., -1].to(x.dtype)


def ks_sub_const(x: torch.Tensor, c: torch.Tensor):
    """(x - c) per byte limb with borrow lookahead: (diff bytes,
    borrow_out)."""
    B = ks_prefix(x < c, x <= c)
    r = (x - c - _shift_in(B, 1).to(x.dtype)) & MASK
    return r, B[..., -1].to(x.dtype)


_E40 = 40


def canonical(x: torch.Tensor) -> torch.Tensor:
    """Fully reduce to the canonical representative in [0, p), limbs
    [0, 255] (reference `field.canonical`, `field.py:332`)."""
    x = carry(x, passes=4)
    b, t1 = ks_normalize(x + _E40)
    r, t2 = ks_sub_const(b, torch.full_like(b, _E40))
    r[..., 0] += (t1 - t2) * 38
    b2, t = ks_normalize(r)
    b2[..., 0] += t * 38
    x = b2
    neg_p = _t(_NEG_P, x)
    for _ in range(2):
        s, t3 = ks_normalize(x + neg_p)
        x = torch.where((t3 == 1)[..., None], s, x)
    return x


def is_zero(x):
    return (canonical(x) == 0).all(dim=-1)


def eq(a, b):
    return is_zero(sub(a, b))


def parity(x):
    return canonical(x)[..., 0] & 1


def to_bytes(x) -> torch.Tensor:
    return canonical(x).to(torch.uint8)


def from_bytes(b: torch.Tensor) -> torch.Tensor:
    return b.to(torch.int64)
