"""secp256k1 key type — the reference crypto suite's alternative scheme.

Copy of `tendermint_tpu/crypto/secp256k1.py`: account/client identities
(never validator votes) over the OpenSSL-backed `cryptography`
primitives, on the host.  Signatures are DER-encoded ECDSA-SHA256;
public keys are 33-byte compressed SEC1 points.  Where `cryptography` is
not installed, `AVAILABLE` is False and every key operation raises; the
mempool then answers a secp256k1 envelope with "secp256k1 support
unavailable", as the reference does.
"""

from __future__ import annotations

from dataclasses import dataclass

try:
    from cryptography.exceptions import InvalidSignature
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import ec
    AVAILABLE = True
except ImportError:                      # pragma: no cover - env dependent
    AVAILABLE = False

from tendermint_tpu_torch.types.keys import address_from_pubkey

PUBKEY_LEN = 33     # compressed SEC1


@dataclass(frozen=True)
class PubKeySecp256k1:
    bytes_: bytes    # compressed SEC1 point

    def __post_init__(self):
        if len(self.bytes_) != PUBKEY_LEN:
            raise ValueError("secp256k1 pubkey must be 33 bytes (SEC1)")

    @property
    def address(self) -> bytes:
        return address_from_pubkey(self.bytes_)

    def verify(self, msg: bytes, sig: bytes) -> bool:
        if not AVAILABLE:
            raise RuntimeError("cryptography package unavailable")
        try:
            pub = ec.EllipticCurvePublicKey.from_encoded_point(
                ec.SECP256K1(), self.bytes_)
            pub.verify(sig, msg, ec.ECDSA(hashes.SHA256()))
            return True
        except (InvalidSignature, ValueError):
            return False

    def hex(self) -> str:
        return self.bytes_.hex()


class PrivKeySecp256k1:
    def __init__(self, secret: bytes):
        if not AVAILABLE:
            raise RuntimeError("cryptography package unavailable")
        if len(secret) != 32:
            raise ValueError("secret must be 32 bytes")
        self._key = ec.derive_private_key(
            int.from_bytes(secret, "big"), ec.SECP256K1())
        self.secret = secret

    @property
    def pub_key(self) -> PubKeySecp256k1:
        pub = self._key.public_key().public_bytes(
            serialization.Encoding.X962,
            serialization.PublicFormat.CompressedPoint)
        return PubKeySecp256k1(pub)

    def sign(self, msg: bytes) -> bytes:
        return self._key.sign(msg, ec.ECDSA(hashes.SHA256()))
