"""ed25519 key types and addresses.

Copy of `tendermint_tpu/types/keys.py` for the port.  Addresses are
sha256(pubkey)[:20].  Scalar sign/verify run on the golden bigint
reference (`crypto.pure_ed25519`); bulk verification goes through
`crypto.backend`.
"""

from __future__ import annotations

import functools
import hashlib
import secrets
from dataclasses import dataclass

from tendermint_tpu_torch.crypto import pure_ed25519 as _ed

ADDRESS_LEN = 20

# Verification is a pure function of (pubkey, msg, sig), so its result
# can be memoized soundly.
_VERIFY_MEMO_SIZE = 1 << 16


@functools.lru_cache(maxsize=_VERIFY_MEMO_SIZE)
def _verify_memo(pub: bytes, msg: bytes, sig: bytes) -> bool:
    return _ed.verify(pub, msg, sig)


def address_from_pubkey(pub: bytes) -> bytes:
    return hashlib.sha256(pub).digest()[:ADDRESS_LEN]


@dataclass(frozen=True)
class PubKey:
    """32-byte ed25519 public key."""
    bytes_: bytes

    def __post_init__(self):
        if len(self.bytes_) != 32:
            raise ValueError("pubkey must be 32 bytes")

    @property
    def address(self) -> bytes:
        # cached: one sha256 per validator per proposer-rotation step
        a = self.__dict__.get("_addr")
        if a is None:
            a = self.__dict__["_addr"] = address_from_pubkey(self.bytes_)
        return a

    def verify(self, msg: bytes, sig: bytes) -> bool:
        return _verify_memo(self.bytes_, msg, sig)

    def hex(self) -> str:
        return self.bytes_.hex()


@dataclass(frozen=True)
class PrivKey:
    """32-byte seed; signing is deterministic RFC-8032."""
    seed: bytes

    def __post_init__(self):
        if len(self.seed) != 32:
            raise ValueError("seed must be 32 bytes")

    @classmethod
    def generate(cls) -> "PrivKey":
        return cls(secrets.token_bytes(32))

    @property
    def pub_key(self) -> PubKey:
        return PubKey(_ed.pubkey_from_seed(self.seed))

    def sign(self, msg: bytes) -> bytes:
        return _ed.sign(self.seed, msg)
