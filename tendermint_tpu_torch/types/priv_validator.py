"""File-backed validator signing key with anti-double-sign protection.

Reference: `types/priv_validator.go` — monotonic (height, round, step)
guard with last-signature replay (`signBytesHRS` `:206-249`), atomic file
persist on every sign (`:150-167`), pluggable Signer (`:60-63`),
`LoadOrGenPrivValidator` (`:126`).  Signing stays host-side: it is one
signature per consensus step, safety-critical, and never batched.

Copy of `tendermint_tpu/types/priv_validator.py`; the JSON file is the
same byte for byte, so either package loads the other's.
"""

from __future__ import annotations

import json
import os
import tempfile
import threading

from tendermint_tpu_torch.types.keys import PrivKey, PubKey

# step ordering within a round (reference types/priv_validator.go:22-26)
STEP_NONE = 0
STEP_PROPOSE = 1
STEP_PREVOTE = 2
STEP_PRECOMMIT = 3

_VOTE_STEP = {1: STEP_PREVOTE, 2: STEP_PRECOMMIT}


class DoubleSignError(Exception):
    pass


class PrivValidator:
    """Signs votes/proposals, refusing any regression of (H, R, S); for an
    exact (H, R, S) repeat with identical sign-bytes it replays the cached
    signature (crash-recovery idempotence, reference `:228-245`)."""

    def __init__(self, priv_key: PrivKey, file_path: str | None = None):
        self.priv_key = priv_key
        self.pub_key: PubKey = priv_key.pub_key
        self.file_path = file_path
        self.last_height = 0
        self.last_round = 0
        self.last_step = STEP_NONE
        self.last_sign_bytes: bytes = b""
        self.last_signature: bytes = b""
        self._lock = threading.Lock()

    @property
    def address(self) -> bytes:
        return self.pub_key.address

    # -- persistence ----------------------------------------------------
    @classmethod
    def generate(cls, file_path: str | None = None) -> "PrivValidator":
        pv = cls(PrivKey.generate(), file_path)
        if file_path:
            pv.save()
        return pv

    @classmethod
    def load(cls, file_path: str) -> "PrivValidator":
        with open(file_path) as f:
            d = json.load(f)
        pv = cls(PrivKey(bytes.fromhex(d["priv_key"])), file_path)
        pv.last_height = d.get("last_height", 0)
        pv.last_round = d.get("last_round", 0)
        pv.last_step = d.get("last_step", STEP_NONE)
        pv.last_sign_bytes = bytes.fromhex(d.get("last_sign_bytes", ""))
        pv.last_signature = bytes.fromhex(d.get("last_signature", ""))
        return pv

    @classmethod
    def load_or_generate(cls, file_path: str) -> "PrivValidator":
        """Reference `types/priv_validator.go:126` LoadOrGenPrivValidator."""
        if os.path.exists(file_path):
            return cls.load(file_path)
        return cls.generate(file_path)

    def save(self) -> None:
        """Atomic write-then-rename (reference `:150-167`)."""
        if not self.file_path:
            return
        d = {
            "address": self.address.hex(),
            "pub_key": self.pub_key.bytes_.hex(),
            "priv_key": self.priv_key.seed.hex(),
            "last_height": self.last_height,
            "last_round": self.last_round,
            "last_step": self.last_step,
            "last_sign_bytes": self.last_sign_bytes.hex(),
            "last_signature": self.last_signature.hex(),
        }
        dir_ = os.path.dirname(os.path.abspath(self.file_path))
        os.makedirs(dir_, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=dir_, prefix=".privval")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(d, f, indent=2)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.file_path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

    # -- signing --------------------------------------------------------
    def _sign_hrs(self, height: int, round_: int, step: int,
                  sign_bytes: bytes) -> bytes:
        """The HRS guard (reference `signBytesHRS` `:206-249`)."""
        with self._lock:
            hrs = (height, round_, step)
            last = (self.last_height, self.last_round, self.last_step)
            if hrs < last:
                raise DoubleSignError(
                    f"sign request {hrs} regresses from {last}")
            if hrs == last:
                if sign_bytes == self.last_sign_bytes:
                    return self.last_signature  # crash-replay idempotence
                raise DoubleSignError(
                    f"conflicting sign-bytes at {hrs} (equivocation)")
            sig = self.priv_key.sign(sign_bytes)
            self.last_height, self.last_round, self.last_step = hrs
            self.last_sign_bytes = sign_bytes
            self.last_signature = sig
            self.save()
            return sig

    def sign_vote(self, chain_id: str, vote) -> bytes:
        """Returns the signature; caller attaches it to the vote."""
        step = _VOTE_STEP[vote.type]
        return self._sign_hrs(vote.height, vote.round, step,
                              vote.sign_bytes(chain_id))

    def sign_proposal(self, chain_id: str, proposal) -> bytes:
        return self._sign_hrs(proposal.height, proposal.round, STEP_PROPOSE,
                              proposal.sign_bytes(chain_id))

    def sign_heartbeat(self, chain_id: str, hb) -> bytes:
        """Heartbeats are not double-sign relevant; plain sign."""
        return self.priv_key.sign(hb.sign_bytes(chain_id))

    def reset(self) -> None:
        """unsafe_reset: clear the HRS state (testing only).  Taken
        under the lock like _sign_hrs — a signer mid-HRS-check must see
        either the old state or the fully-reset one, never a torn mix."""
        with self._lock:
            self.last_height = 0
            self.last_round = 0
            self.last_step = STEP_NONE
            self.last_sign_bytes = b""
            self.last_signature = b""
            self.save()

    def __str__(self):
        return f"PrivValidator[{self.address.hex()[:8]}]"
