"""SecretConnection: authenticated-encryption transport for peer links.

Reference: `p2p/secret_connection.go:49-101` — Station-to-Station pattern:
X25519 ephemeral ECDH -> shared secret -> per-direction symmetric keys ->
encrypted frames; then each side signs the session challenge with its
long-lived ed25519 node key and exchanges the (pubkey, sig) pair inside
the encrypted channel, authenticating the link without revealing identity
to eavesdroppers.

This framework's cipher suite is built from stdlib primitives (no
external crypto deps): SHA-256 in counter mode as the stream keystream
and truncated HMAC-SHA256 as the per-frame MAC (encrypt-then-MAC), with
per-direction keys and a monotonically increasing frame sequence baked
into both keystream and MAC so frames cannot be replayed, reordered, or
reflected.  X25519 is RFC 7748 in pure Python — one ladder per
handshake, off the hot path.

Frame wire format:  len(u32) ciphertext[len] tag[16]

Copy of `tendermint_tpu/p2p/secret.py` with the same frames byte for
byte.  A frame's keystream is the same SHA-256 counter blocks, built in
one list pass over precomputed counters, and the XOR runs on whole frames
as Python integers instead of byte by byte; the MAC is the one-shot
`hmac.digest`.
"""

from __future__ import annotations

import hashlib
import hmac
import os
import struct

from tendermint_tpu_torch.types.keys import PrivKey, PubKey

# ---------------------------------------------------------------------------
# X25519 (RFC 7748) — handshake only
# ---------------------------------------------------------------------------

_P = 2**255 - 19
_A24 = 121665


def _decode_scalar(k: bytes) -> int:
    b = bytearray(k)
    b[0] &= 248
    b[31] &= 127
    b[31] |= 64
    return int.from_bytes(b, "little")


def _decode_u(u: bytes) -> int:
    b = bytearray(u)
    b[31] &= 127
    return int.from_bytes(b, "little") % _P


def x25519(k: bytes, u: bytes) -> bytes:
    """Scalar multiplication on curve25519 (montgomery ladder)."""
    k_int = _decode_scalar(k)
    x1 = _decode_u(u)
    x2, z2, x3, z3 = 1, 0, x1, 1
    swap = 0
    for t in range(254, -1, -1):
        bit = (k_int >> t) & 1
        swap ^= bit
        if swap:
            x2, x3 = x3, x2
            z2, z3 = z3, z2
        swap = bit
        a = (x2 + z2) % _P
        aa = a * a % _P
        b = (x2 - z2) % _P
        bb = b * b % _P
        e = (aa - bb) % _P
        c = (x3 + z3) % _P
        d = (x3 - z3) % _P
        da = d * a % _P
        cb = c * b % _P
        x3 = (da + cb) % _P
        x3 = x3 * x3 % _P
        z3 = (da - cb) % _P
        z3 = z3 * z3 % _P
        z3 = z3 * x1 % _P
        x2 = aa * bb % _P
        z2 = e * (aa + _A24 * e) % _P
    if swap:
        x2, x3 = x3, x2
        z2, z3 = z3, z2
    out = x2 * pow(z2, _P - 2, _P) % _P
    return out.to_bytes(32, "little")


_BASEPOINT = (9).to_bytes(32, "little")


def x25519_keypair() -> tuple[bytes, bytes]:
    priv = os.urandom(32)
    return priv, x25519(priv, _BASEPOINT)


# ---------------------------------------------------------------------------
# key schedule + AE stream
# ---------------------------------------------------------------------------

def _hkdf(secret: bytes, info: bytes, n: int) -> bytes:
    """HKDF-SHA256 (RFC 5869), fixed salt."""
    prk = hmac.new(b"tendermint-tpu-secret-conn", secret,
                   hashlib.sha256).digest()
    out, t = b"", b""
    i = 1
    while len(out) < n:
        t = hmac.new(prk, t + info + bytes([i]), hashlib.sha256).digest()
        out += t
        i += 1
    return out[:n]


# big-endian block counters for the largest frame (MAX_FRAME bytes)
_CTRS = [struct.pack(">I", c) for c in range(((1 << 20) + 31) // 32)]


def _xor(a: bytes, b: bytes) -> bytes:
    """a XOR b over len(a) bytes (b at least as long), as integers."""
    n = len(a)
    return (int.from_bytes(a, "little") ^
            int.from_bytes(b[:n], "little")).to_bytes(n, "little")


class _Direction:
    """One direction's cipher state: enc key, mac key, frame sequence."""

    __slots__ = ("key", "mac_key", "seq")

    def __init__(self, key: bytes, mac_key: bytes):
        self.key = key
        self.mac_key = mac_key
        self.seq = 0

    def _keystream(self, n: int) -> bytes:
        base = self.key + struct.pack(">Q", self.seq)
        sha = hashlib.sha256
        return b"".join([sha(base + c).digest()
                         for c in _CTRS[:(n + 31) // 32]])[:n]

    def _tag(self, ct: bytes) -> bytes:
        return hmac.digest(self.mac_key, struct.pack(">Q", self.seq) + ct,
                           "sha256")[:16]

    def seal(self, plaintext: bytes) -> bytes:
        ct = _xor(plaintext, self._keystream(len(plaintext)))
        tag = self._tag(ct)
        self.seq += 1
        return ct + tag

    def open(self, ct_and_tag: bytes) -> bytes:
        ct, tag = ct_and_tag[:-16], ct_and_tag[-16:]
        if not hmac.compare_digest(tag, self._tag(ct)):
            raise ValueError("secret connection: bad frame MAC")
        ks = self._keystream(len(ct))
        self.seq += 1
        return _xor(ct, ks)


class SecretConnection:
    """Wraps a StreamConn; presents the same read_exact/write/close API so
    MConnection can layer transparently on top."""

    MAX_FRAME = 1 << 20

    def __init__(self, conn, priv_key: PrivKey):
        self._conn = conn
        # 1. ephemeral key exchange (in the clear)
        eph_priv, eph_pub = x25519_keypair()
        conn.write(eph_pub)
        their_eph = conn.read_exact(32)
        secret = x25519(eph_priv, their_eph)
        if secret == b"\x00" * 32:
            raise ValueError("secret connection: low-order peer point")
        # 2. directional keys: ordered by ephemeral pubkey so both sides
        #    derive the same assignment (reference sorts to pick nonces)
        lo, hi = sorted([eph_pub, their_eph])
        keys = _hkdf(secret, b"keys" + lo + hi, 128)
        if eph_pub == lo:
            send_k, recv_k = keys[0:32], keys[32:64]
            send_m, recv_m = keys[64:96], keys[96:128]
        else:
            recv_k, send_k = keys[0:32], keys[32:64]
            recv_m, send_m = keys[64:96], keys[96:128]
        self._send = _Direction(send_k, send_m)
        self._recv = _Direction(recv_k, recv_m)
        self._rbuf = bytearray()
        # 3. authenticate: sign the transcript challenge with the node key
        #    and swap (pubkey, sig) inside the encrypted channel
        challenge = hashlib.sha256(
            b"challenge" + secret + lo + hi).digest()
        sig = priv_key.sign(challenge)
        self._write_frame(priv_key.pub_key.bytes_ + sig)
        auth = self._read_frame()
        if len(auth) != 96:
            raise ValueError("secret connection: bad auth frame")
        their_pub, their_sig = auth[:32], auth[32:]
        if not PubKey(their_pub).verify(challenge, their_sig):
            raise ValueError("secret connection: peer failed challenge")
        self.remote_pub_key = their_pub

    # -- framing --------------------------------------------------------
    def _write_frame(self, plaintext: bytes) -> None:
        sealed = self._send.seal(plaintext)
        self._conn.write(struct.pack(">I", len(sealed)) + sealed)

    def _read_frame(self) -> bytes:
        n = struct.unpack(">I", self._conn.read_exact(4))[0]
        if not 16 <= n <= self.MAX_FRAME:
            raise ValueError(f"secret connection: bad frame length {n}")
        return self._recv.open(self._conn.read_exact(n))

    # -- StreamConn API -------------------------------------------------
    def write(self, data: bytes) -> None:
        # one frame per write call: MConnection writes whole packets
        self._write_frame(data)

    def read_exact(self, n: int) -> bytes:
        while len(self._rbuf) < n:
            self._rbuf += self._read_frame()
        out = bytes(self._rbuf[:n])
        del self._rbuf[:n]
        return out

    def close(self) -> None:
        self._conn.close()

    @property
    def closed(self) -> bool:
        return self._conn.closed

    @property
    def label(self) -> str:
        return getattr(self._conn, "label", "")
