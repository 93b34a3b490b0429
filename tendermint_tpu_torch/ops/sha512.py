"""Batched SHA-512 — the plain PyTorch twin of `tendermint_tpu/ops/sha512.py`.

ed25519 needs SHA-512 for the challenge k = H(R || A || M).  torch's
unsigned 64-bit support is partial, so each 64-bit word is a (hi, lo)
pair of 32-bit halves held in int64 and masked after every shift and add
— the reference's paired-uint32 layout (`sha512.py:47-69`).  The CUDA
kernels hash on native uint64 (`csrc/tm_sha512.cuh`); this twin is their
CPU path and the yardstick they are held against.
"""

from __future__ import annotations

import numpy as np
import torch

_K64 = [
    0x428a2f98d728ae22, 0x7137449123ef65cd, 0xb5c0fbcfec4d3b2f, 0xe9b5dba58189dbbc,
    0x3956c25bf348b538, 0x59f111f1b605d019, 0x923f82a4af194f9b, 0xab1c5ed5da6d8118,
    0xd807aa98a3030242, 0x12835b0145706fbe, 0x243185be4ee4b28c, 0x550c7dc3d5ffb4e2,
    0x72be5d74f27b896f, 0x80deb1fe3b1696b1, 0x9bdc06a725c71235, 0xc19bf174cf692694,
    0xe49b69c19ef14ad2, 0xefbe4786384f25e3, 0x0fc19dc68b8cd5b5, 0x240ca1cc77ac9c65,
    0x2de92c6f592b0275, 0x4a7484aa6ea6e483, 0x5cb0a9dcbd41fbd4, 0x76f988da831153b5,
    0x983e5152ee66dfab, 0xa831c66d2db43210, 0xb00327c898fb213f, 0xbf597fc7beef0ee4,
    0xc6e00bf33da88fc2, 0xd5a79147930aa725, 0x06ca6351e003826f, 0x142929670a0e6e70,
    0x27b70a8546d22ffc, 0x2e1b21385c26c926, 0x4d2c6dfc5ac42aed, 0x53380d139d95b3df,
    0x650a73548baf63de, 0x766a0abb3c77b2a8, 0x81c2c92e47edaee6, 0x92722c851482353b,
    0xa2bfe8a14cf10364, 0xa81a664bbc423001, 0xc24b8b70d0f89791, 0xc76c51a30654be30,
    0xd192e819d6ef5218, 0xd69906245565a910, 0xf40e35855771202a, 0x106aa07032bbd1b8,
    0x19a4c116b8d2d0c8, 0x1e376c085141ab53, 0x2748774cdf8eeb99, 0x34b0bcb5e19b48a8,
    0x391c0cb3c5c95a63, 0x4ed8aa4ae3418acb, 0x5b9cca4f7763e373, 0x682e6ff3d6b2b8a3,
    0x748f82ee5defb2fc, 0x78a5636f43172f60, 0x84c87814a1f0ab72, 0x8cc702081a6439ec,
    0x90befffa23631e28, 0xa4506cebde82bde9, 0xbef9a3f7b2c67915, 0xc67178f2e372532b,
    0xca273eceea26619c, 0xd186b8c721c0c207, 0xeada7dd6cde0eb1e, 0xf57d4f7fee6ed178,
    0x06f067aa72176fba, 0x0a637dc5a2c898a6, 0x113f9804bef90dae, 0x1b710b35131c471b,
    0x28db77f523047d84, 0x32caab7b40c72493, 0x3c9ebe0a15c9bebc, 0x431d67c49c100d4c,
    0x4cc5d4becb3e42b6, 0x597f299cfc657e2a, 0x5fcb6fab3ad6faec, 0x6c44198c4a475817,
]
_H0 = [0x6a09e667f3bcc908, 0xbb67ae8584caa73b, 0x3c6ef372fe94f82b,
       0xa54ff53a5f1d36f1, 0x510e527fade682d1, 0x9b05688c2b3e6c1f,
       0x1f83d9abfb41bd6b, 0x5be0cd19137e2179]

_M32 = 0xFFFFFFFF


def _add64(a, b):
    lo = a[1] + b[1]
    return (a[0] + b[0] + (lo >> 32)) & _M32, lo & _M32


def _const64(k: int):
    return (k >> 32, k & _M32)


def _rotr64(x, n: int):
    h, l = x
    if n >= 32:
        h, l, n = l, h, n - 32
    if n == 0:
        return h, l
    return (((h >> n) | (l << (32 - n))) & _M32,
            ((l >> n) | (h << (32 - n))) & _M32)


def _shr64(x, n: int):
    h, l = x
    return h >> n, ((l >> n) | (h << (32 - n))) & _M32


def _xor3(a, b, c):
    return a[0] ^ b[0] ^ c[0], a[1] ^ b[1] ^ c[1]


def pad(nbytes: int) -> np.ndarray:
    """Static SHA-512 padding suffix (uint8[...]): 0x80, zeros, 128-bit len."""
    padlen = (112 - (nbytes + 1)) % 128
    tail = np.zeros(1 + padlen + 16, dtype=np.uint8)
    tail[0] = 0x80
    bits = nbytes * 8
    for i in range(16):
        tail[-1 - i] = (bits >> (8 * i)) & 0xFF
    return tail


def _compress(state: list, w: list) -> list:
    """One compression over 16 (hi, lo) message words."""
    w = list(w)
    for t in range(16, 80):
        a, b = w[t - 15], w[t - 2]
        s0 = _xor3(_rotr64(a, 1), _rotr64(a, 8), _shr64(a, 7))
        s1 = _xor3(_rotr64(b, 19), _rotr64(b, 61), _shr64(b, 6))
        w.append(_add64(_add64(w[t - 16], s0), _add64(w[t - 7], s1)))
    a, b, c, d, e, f, g, h = state
    for t in range(80):
        s1 = _xor3(_rotr64(e, 14), _rotr64(e, 18), _rotr64(e, 41))
        ch = ((e[0] & f[0]) ^ ((e[0] ^ _M32) & g[0]),
              (e[1] & f[1]) ^ ((e[1] ^ _M32) & g[1]))
        t1 = _add64(_add64(h, s1), _add64(ch, _add64(_const64(_K64[t]),
                                                      w[t])))
        s0 = _xor3(_rotr64(a, 28), _rotr64(a, 34), _rotr64(a, 39))
        maj = ((a[0] & b[0]) ^ (a[0] & c[0]) ^ (b[0] & c[0]),
               (a[1] & b[1]) ^ (a[1] & c[1]) ^ (b[1] & c[1]))
        t2 = _add64(s0, maj)
        a, b, c, d, e, f, g, h = (_add64(t1, t2), a, b, c, _add64(d, t1),
                                  e, f, g)
    return [_add64(s, n) for s, n in zip(state, (a, b, c, d, e, f, g, h))]


def sha512(msg: torch.Tensor) -> torch.Tensor:
    """uint8[..., N] -> digest uint8[..., 64]."""
    n = msg.shape[-1]
    tail = torch.as_tensor(pad(n), device=msg.device)
    padded = torch.cat([msg, tail.expand(msg.shape[:-1] + tail.shape)],
                       dim=-1).to(torch.int64)
    nblocks = padded.shape[-1] // 128
    b = padded.reshape(msg.shape[:-1] + (nblocks, 16, 8))
    hi = (b[..., 0] << 24) | (b[..., 1] << 16) | (b[..., 2] << 8) | b[..., 3]
    lo = (b[..., 4] << 24) | (b[..., 5] << 16) | (b[..., 6] << 8) | b[..., 7]
    zero = torch.zeros(msg.shape[:-1], dtype=torch.int64, device=msg.device)
    state = [(zero + (h0 >> 32), zero + (h0 & _M32)) for h0 in _H0]
    for i in range(nblocks):
        state = _compress(state, [(hi[..., i, j], lo[..., i, j])
                                  for j in range(16)])
    words = torch.stack([x for pair in state for x in pair], dim=-1)
    parts = [(words >> s) & 0xFF for s in (24, 16, 8, 0)]
    return torch.stack(parts, dim=-1).reshape(
        msg.shape[:-1] + (64,)).to(torch.uint8)
