"""Batched arithmetic mod the ed25519 group order L — the plain PyTorch
twin of `tendermint_tpu/ops/scalar.py`.

L = 2^252 + 27742317777372353535851937790883648493.  Little-endian
radix-2^8 limbs (bytes == limbs) held in int64; the same signed fold
2^256 = -16c (mod L), Kogge-Stone carry and conditional-subtraction
ladder as the reference, so `reduce512`, `lt_L`, `muladd_mod_L` and
`nibbles` return the reference's bytes.  The CUDA kernels reduce on
64-bit words (`csrc/tm_scalar.cuh`).
"""

from __future__ import annotations

import numpy as np
import torch

from tendermint_tpu_torch.ops.field import ks_normalize, ks_sub_const

L = 2**252 + 27742317777372353535851937790883648493
_C = L - 2**252            # 125 bits
_C16 = 16 * _C             # 129 bits -> 17 limbs


def _int_to_limbs(x: int, n: int) -> np.ndarray:
    if not 0 <= x < 1 << (8 * n):
        raise ValueError("scalar out of range")
    return np.array([(x >> (8 * i)) & 0xFF for i in range(n)], dtype=np.int64)


_C16_LIMBS = _int_to_limbs(_C16, 17)
L_LIMBS = _int_to_limbs(L, 33)
_KL_LIMBS = [_int_to_limbs(k * L, 33) for k in (16, 8, 4, 2, 1)]


def _pad_to(x: torch.Tensor, n: int) -> torch.Tensor:
    return torch.nn.functional.pad(x, (0, n - x.shape[-1]))


def _carry(x: torch.Tensor) -> torch.Tensor:
    """Signed exact carry: limbs -> [0,255] plus an appended top limb
    (reference `scalar._carry`)."""
    body, top = x, torch.zeros_like(x[..., 0])
    for _ in range(4):
        c = body >> 8
        body = body & 0xFF
        body = torch.cat([body[..., :1], body[..., 1:] + c[..., :-1]], -1)
        top = top + c[..., -1]
    b, t1 = ks_normalize(body + 1)
    r, t2 = ks_sub_const(b, torch.ones_like(b))
    return torch.cat([r, (top + t1 - t2)[..., None]], dim=-1)


def _mul_const(a: torch.Tensor, const: np.ndarray) -> torch.Tensor:
    na, nb = a.shape[-1], len(const)
    acc = a.new_zeros(a.shape[:-1] + (na + nb - 1,))
    for i in range(nb):
        acc[..., i:i + na] += a * int(const[i])
    return acc


def _fold(x: torch.Tensor) -> torch.Tensor:
    """One application of  hi*2^256 + lo  ->  lo - 16c*hi  (mod L)."""
    lo, hi = x[..., :32], x[..., 32:]
    prod = _mul_const(hi, _C16_LIMBS)
    n = max(32, prod.shape[-1])
    return _carry(_pad_to(lo, n) - _pad_to(prod, n))


def _csub(x: torch.Tensor, const: np.ndarray) -> torch.Tensor:
    diff, borrow = ks_sub_const(x, torch.as_tensor(const, device=x.device))
    return torch.where((borrow == 0)[..., None], diff, x)


def reduce512(h: torch.Tensor) -> torch.Tensor:
    """SHA-512 digest uint8[..., 64] (little-endian) -> (h mod L)
    int64[..., 32]."""
    x = h.to(torch.int64)
    x = _fold(x)
    x = _fold(x)
    x = _fold(x)
    x = _carry(x[..., :33] + torch.as_tensor(L_LIMBS, device=x.device))
    x = x[..., :33]
    for kl in _KL_LIMBS:
        x = _csub(x, kl)
    return x[..., :32]


def lt_const(b: torch.Tensor, const_limbs: np.ndarray) -> torch.Tensor:
    """Little-endian bytes/limbs [..., N] < constant -> bool[...]."""
    _, borrow = ks_sub_const(b.to(torch.int64),
                             torch.as_tensor(const_limbs, device=b.device))
    return borrow == 1


def lt_L(s: torch.Tensor) -> torch.Tensor:
    """Malleability check: uint8[..., 32] little-endian value < L."""
    return lt_const(s, L_LIMBS[:32])


def muladd_mod_L(k: torch.Tensor, a: torch.Tensor,
                 r: torch.Tensor) -> torch.Tensor:
    """(r + k*a) mod L for little-endian limb vectors [..., 32] — RFC 8032
    step 5, S = (r + k*s) mod L (reference `scalar.muladd_mod_L`)."""
    k, a, r = (t.to(torch.int64) for t in (k, a, r))
    acc = k.new_zeros(k.shape[:-1] + (63,))
    for i in range(32):
        acc[..., i:i + 32] += k * a[..., i:i + 1]
    acc[..., :32] += r
    return reduce512(_carry(_pad_to(acc, 64))[..., :64])


def nibbles(s: torch.Tensor) -> torch.Tensor:
    """Limbs/bytes [..., 32] -> 64 little-endian 4-bit windows int64[..., 64]
    (reference `scalar.nibbles`)."""
    x = s.to(torch.int64)
    return torch.stack([x & 0xF, (x >> 4) & 0xF], dim=-1).reshape(
        s.shape[:-1] + (64,))


def limbs_to_int(limbs) -> int:
    arr = np.asarray(limbs)
    return sum(int(arr[..., i]) << (8 * i) for i in range(arr.shape[-1]))
