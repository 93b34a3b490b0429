"""Native-speed CPU ed25519 backend: the crypto ladder's middle rung.

Copy of `tendermint_tpu/crypto/native.py` for the port.  The JAX rung
rides OpenSSL through the `cryptography` wheel; the port's is its own C++
(`native/ed25519.cpp`, built by `utils.nativelib` with the host compiler)
over ctypes, with the semantics of `crypto.pure_ed25519` and the bytes of
its signer.  The library's calls release the GIL, and a batch runs on C++
threads.  The backend also answers `leaf_hashes` through the library's
`tm_leaf_hashes` (the port passes backends explicitly, so this is where
the JAX package's separate `nativelib.leaf_hashes` call lives).

No fallback: a failed build raises.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from tendermint_tpu_torch.crypto.backend import PythonBackend
from tendermint_tpu_torch.utils import nativelib
from tendermint_tpu_torch.utils.metrics import REGISTRY


def verify_one(pub: bytes, msg: bytes, sig: bytes) -> bool:
    """Scalar native verify — the live-consensus hot path."""
    if len(pub) != 32 or len(sig) != 64:
        return False
    return nativelib.get().tm_ed25519_verify(pub, msg, len(msg), sig) == 1


def sign_one(seed: bytes, msg: bytes) -> bytes:
    """RFC 8032 is deterministic, so this produces bytes identical to the
    golden `pure_ed25519.sign`; the secret scalars are walked in constant
    time."""
    if len(seed) != 32:
        raise ValueError("seed must be 32 bytes")
    out = ctypes.create_string_buffer(64)
    nativelib.get().tm_ed25519_sign(seed, msg, len(msg), out)
    return out.raw


def pubkey_from_seed(seed: bytes) -> bytes:
    """The public key of a 32-byte seed, as `pure_ed25519.pubkey_from_seed`."""
    if len(seed) != 32:
        raise ValueError("seed must be 32 bytes")
    out = ctypes.create_string_buffer(32)
    nativelib.get().tm_ed25519_pubkey(seed, out)
    return out.raw


class NativeBackend(PythonBackend):
    """Scalar verification on C++ threads; same Backend protocol as the
    device kernels so consensus cannot tell them apart.  The grouped and
    templated forms gather their lanes on the host, as the python
    backend's do."""

    name = "native"

    def __init__(self, workers: int | None = None):
        self._workers = workers or min(32, (os.cpu_count() or 1))
        nativelib.get()                  # build now: a failure raises here

    def verify_batch(self, pubkeys, msgs, sigs) -> np.ndarray:
        if len(pubkeys) == 0:
            return np.zeros(0, dtype=bool)
        out = nativelib.ed25519_verify_batch(pubkeys, msgs, sigs,
                                             self._workers)
        REGISTRY.sigs_requested.inc(len(pubkeys))
        REGISTRY.sigs_verified.inc(int(out.sum()))
        return out

    def leaf_hashes(self, chunks: np.ndarray) -> np.ndarray:
        """Merkle leaf hashes SHA-256(0x00 || chunk) of equal-size chunks
        uint8[n, L] -> uint8[n, 32], on the host's threads."""
        return nativelib.leaf_hashes(chunks)
