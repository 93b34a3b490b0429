"""Batched SHA-256 — the plain PyTorch twin of `tendermint_tpu/ops/sha256.py`,
and the wrapper of kernel K4 (`csrc/sha256_prefixed.cu`).

32-bit words are held in int64 and masked back to 32 bits after every
sum and after each sigma's rotations.
`sha256_prefixed` hashes prefix_byte || msg for N equal-length messages:
Merkle leaves (prefix 0x00) and inner nodes (0x01 || left || right).  On a
CUDA tensor it launches K4; on a CPU tensor it runs the plain twin.  K4
picks its route from the shape alone, as `_k4_route` says.
"""

from __future__ import annotations

import numpy as np
import torch

from tendermint_tpu_torch.ops import kernels

_K = [
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
    0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
    0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
    0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
    0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2]
_H0 = [0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
       0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19]

_M32 = 0xFFFFFFFF


def pad(nbytes: int) -> np.ndarray:
    """The static SHA-256 padding suffix for an nbytes message (uint8[...])."""
    padlen = (56 - (nbytes + 1)) % 64
    tail = np.zeros(1 + padlen + 8, dtype=np.uint8)
    tail[0] = 0x80
    bits = nbytes * 8
    for i in range(8):
        tail[-1 - i] = (bits >> (8 * i)) & 0xFF
    return tail


# A rotation of a 32-bit word x held in int64 is (x >> n) | (x << (32 - n))
# in its low 32 bits; the bits above stay below 2**62 and are masked off
# once, after the three rotations of a sigma are XORed.

def _schedule(w: list) -> list:
    """The 64-word message schedule of a block from its 16 words (ints, or
    tensors of one word per row)."""
    w = list(w)
    for t in range(16, 64):
        x, y = w[t - 15], w[t - 2]
        s0 = ((x >> 7) | (x << 25)) ^ ((x >> 18) | (x << 14)) ^ (x >> 3)
        s1 = ((y >> 17) | (y << 15)) ^ ((y >> 19) | (y << 13)) ^ (y >> 10)
        w.append((w[t - 16] + (s0 & _M32) + w[t - 7] + (s1 & _M32)) & _M32)
    return w


def _rounds(state: list, kw: list) -> list:
    """The 64 rounds on K[t] + W[t] (`kw`), added to `state`."""
    a, b, c, d, e, f, g, h = state
    for t in range(64):
        s1 = (((e >> 6) | (e << 26)) ^ ((e >> 11) | (e << 21))
              ^ ((e >> 25) | (e << 7))) & _M32
        t1 = h + s1 + (g ^ (e & (f ^ g))) + kw[t]
        s0 = (((a >> 2) | (a << 30)) ^ ((a >> 13) | (a << 19))
              ^ ((a >> 22) | (a << 10))) & _M32
        maj = (a & b) | (c & (a | b))
        a, b, c, d, e, f, g, h = ((t1 + s0 + maj) & _M32, a, b, c,
                                  (d + t1) & _M32, e, f, g)
    return [(s + n) & _M32 for s, n in zip(state, (a, b, c, d, e, f, g, h))]


def _compress(state: list, w: list) -> list:
    """One compression of a block's 16 words into `state`."""
    return _rounds(state, [k + x for k, x in zip(_K, _schedule(w))])


# blocks whose schedules are worked out together, ahead of their rounds
_SCHEDULE_BLOCKS = 64


def sha256(msg: torch.Tensor) -> torch.Tensor:
    """uint8[..., N] -> digest uint8[..., 32].  The schedules of up to
    _SCHEDULE_BLOCKS blocks are computed at once (they depend on the
    message alone); the rounds then run block after block."""
    n = msg.shape[-1]
    tail = torch.as_tensor(pad(n), device=msg.device)
    padded = torch.cat([msg, tail.expand(msg.shape[:-1] + tail.shape)],
                       dim=-1).to(torch.int64)
    nblocks = padded.shape[-1] // 64
    b = padded.reshape(msg.shape[:-1] + (nblocks, 16, 4))
    words = (b[..., 0] << 24) | (b[..., 1] << 16) | (b[..., 2] << 8) | b[..., 3]
    zero = torch.zeros(msg.shape[:-1], dtype=torch.int64, device=msg.device)
    state = [zero + h0 for h0 in _H0]
    for lo in range(0, nblocks, _SCHEDULE_BLOCKS):
        blocks = words[..., lo:lo + _SCHEDULE_BLOCKS, :]
        kw = torch.stack([w + k for k, w in zip(_K, _schedule(
            blocks.unbind(-1)))], dim=-1).movedim(-2, 0)
        for block in kw:
            state = _rounds(state, block.unbind(-1))
    out = torch.stack(state, dim=-1)
    parts = [(out >> s) & 0xFF for s in (24, 16, 8, 0)]
    return torch.stack(parts, dim=-1).reshape(
        msg.shape[:-1] + (32,)).to(torch.uint8)


def sha256_prefixed_plain(msgs: torch.Tensor, prefix: int) -> torch.Tensor:
    """Plain version of K4: SHA-256(prefix || msgs[i]), uint8[N, L] ->
    uint8[N, 32]."""
    pre = torch.full(msgs.shape[:-1] + (1,), prefix, dtype=torch.uint8,
                     device=msgs.device)
    return sha256(torch.cat([pre, msgs], dim=-1))


# bytes of each row per stage of K4's staged route (`K4_STAGE` in
# csrc/sha256_prefixed.cu)
K4_STAGE = 512


def _k4_route(msg_len: int, data_ptr: int) -> tuple:
    """K4's route for rows of msg_len bytes from address data_ptr, as
    `k4_route` in csrc/sha256_prefixed.cu chooses it (the row count only
    sizes the grid): ("staged", 16) for rows of whole 16-byte pieces, at
    least one stage long, on a 16-byte aligned base (cp.async copies
    through shared memory); else ("direct", width), one thread per row
    reading 16-byte pieces, 4-byte words or bytes, the widest that the
    length and the base's alignment allow."""
    if msg_len % 16 == 0 and data_ptr % 16 == 0:
        return ("staged", 16) if msg_len >= K4_STAGE else ("direct", 16)
    if msg_len % 4 == 0 and data_ptr % 4 == 0:
        return ("direct", 4)
    return ("direct", 1)


def sha256_prefixed(msgs: torch.Tensor, prefix: int) -> torch.Tensor:
    """SHA-256(prefix || msgs[i]) for N equal-length messages uint8[N, L]
    -> uint8[N, 32].  Launches K4 for a CUDA tensor, runs the plain twin
    for a CPU tensor."""
    kernels.check(msgs, "msgs", torch.uint8, 2)
    if not 0 <= prefix <= 255:
        raise ValueError(f"prefix byte out of range: {prefix}")
    if msgs.device.type == "cpu":
        return sha256_prefixed_plain(msgs, prefix)
    n, mlen = msgs.shape
    out = torch.empty((n, 32), dtype=torch.uint8, device=msgs.device)
    if n:
        kernels.launch("sha256_prefixed", msgs, mlen, prefix, out, n)
    return out
