"""Plain ed25519 (RFC 8032), the reference's own: Python integers only.

Cofactorless verification, enc([s]B - [H(R, A, M)]A) == R with s < L
enforced, the rule the program's verifiers state.  A frozen copy of the
textbook algorithm, independent of the program; fixed-base products use
a table of 2^i B so that deriving a few hundred keys stays short.
"""

from __future__ import annotations

import hashlib

P = 2**255 - 19
L = 2**252 + 27742317777372353535851937790883648493
D = (-121665 * pow(121666, P - 2, P)) % P
SQRT_M1 = pow(2, (P - 1) // 4, P)


def _recover_x(y: int, sign: int) -> int | None:
    if y >= P:
        return None
    x2 = (y * y - 1) * pow(D * y * y + 1, P - 2, P) % P
    if x2 == 0:
        return None if sign else 0
    x = pow(x2, (P + 3) // 8, P)
    if (x * x - x2) % P != 0:
        x = x * SQRT_M1 % P
    if (x * x - x2) % P != 0:
        return None
    if x & 1 != sign:
        x = P - x
    return x


_BY = 4 * pow(5, P - 2, P) % P
_BX = _recover_x(_BY, 0)
IDENT = (0, 1, 1, 0)
BASE = (_BX, _BY, 1, _BX * _BY % P)


def _add(q, r):
    x1, y1, z1, t1 = q
    x2, y2, z2, t2 = r
    a = (y1 - x1) * (y2 - x2) % P
    b = (y1 + x1) * (y2 + x2) % P
    c = 2 * t1 * t2 * D % P
    d = 2 * z1 * z2 % P
    e, f, g, h = b - a, d - c, d + c, b + a
    return (e * f % P, g * h % P, f * g % P, e * h % P)


def _mul(s: int, q):
    acc = IDENT
    while s > 0:
        if s & 1:
            acc = _add(acc, q)
        q = _add(q, q)
        s >>= 1
    return acc


_POW2_B = [BASE]
for _ in range(255):
    _POW2_B.append(_add(_POW2_B[-1], _POW2_B[-1]))


def _mul_base(s: int):
    acc = IDENT
    i = 0
    while s > 0:
        if s & 1:
            acc = _add(acc, _POW2_B[i])
        s >>= 1
        i += 1
    return acc


def _encode(q) -> bytes:
    x, y, z, _ = q
    zi = pow(z, P - 2, P)
    x, y = x * zi % P, y * zi % P
    return int.to_bytes(y | ((x & 1) << 255), 32, "little")


def _decode(s: bytes):
    n = int.from_bytes(s, "little")
    y = n & ((1 << 255) - 1)
    x = _recover_x(y, n >> 255)
    return None if x is None else (x, y, 1, x * y % P)


def _clamp(a: bytes) -> int:
    n = int.from_bytes(a, "little")
    return (n & ((1 << 254) - 8)) | (1 << 254)


def _h512(*parts: bytes) -> int:
    return int.from_bytes(hashlib.sha512(b"".join(parts)).digest(), "little")


def pubkey(seed: bytes) -> bytes:
    return _encode(_mul_base(_clamp(hashlib.sha512(seed).digest()[:32])))


def sign(seed: bytes, msg: bytes) -> bytes:
    h = hashlib.sha512(seed).digest()
    a = _clamp(h[:32])
    pub = _encode(_mul_base(a))
    r = _h512(h[32:], msg) % L
    rb = _encode(_mul_base(r))
    s = (r + _h512(rb, pub, msg) % L * a) % L
    return rb + int.to_bytes(s, 32, "little")


def verify(pub: bytes, msg: bytes, sig: bytes) -> bool:
    if len(sig) != 64 or len(pub) != 32:
        return False
    a = _decode(pub)
    r = _decode(sig[:32])
    s = int.from_bytes(sig[32:], "little")
    if a is None or r is None or s >= L:
        return False
    k = _h512(sig[:32], pub, msg) % L
    x, y, z, t = a
    got = _add(_mul_base(s), _mul(k, ((P - x) % P, y, z, (P - t) % P)))
    return ((got[0] * r[2] - r[0] * got[2]) % P == 0 and
            (got[1] * r[2] - r[1] * got[2]) % P == 0)
