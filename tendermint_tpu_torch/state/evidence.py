"""Evidence pool: persistent storage + verification of equivocation proofs.

The reference era captures DuplicateVoteEvidence in the vote set
(`types/vote_set.go:195-211`) but drops it after logging; later versions
grew a pool + reactor.  Copy of `tendermint_tpu/state/evidence.py`: the
consensus core's EvidenceDoubleSign events land in a pool that VERIFIES
the proof (both votes correctly signed by the same validator for
conflicting blocks at one (height, round, type)), de-duplicates, persists
it across restarts, and serves it over RPC — block inclusion is
deliberately out of scope (the era's block codec carries no evidence
field).
"""

from __future__ import annotations

import threading

from tendermint_tpu_torch.types.codec import Reader, lp_bytes
from tendermint_tpu_torch.types.vote import DuplicateVoteEvidence, Vote
from tendermint_tpu_torch.utils.log import get_logger

log = get_logger("evidence")


def evidence_key(ev: DuplicateVoteEvidence) -> bytes:
    a = ev.vote_a
    return (b"ev/" + a.validator_address + b"/" +
            a.height.to_bytes(8, "big") + a.round.to_bytes(4, "big") +
            bytes([a.type]))


def encode_evidence(ev: DuplicateVoteEvidence) -> bytes:
    return lp_bytes(ev.vote_a.encode()) + lp_bytes(ev.vote_b.encode())


def decode_evidence(data: bytes) -> DuplicateVoteEvidence:
    r = Reader(data)
    a = Vote.decode(Reader(r.lp_bytes()))
    b = Vote.decode(Reader(r.lp_bytes()))
    r.expect_done()
    return DuplicateVoteEvidence(a, b)


class EvidencePool:
    """Verified, de-duplicated, persisted equivocation proofs.

    `add` is fed by the consensus event switch; `pending` serves RPC.
    Verification requires the accused validator to be in the supplied
    validator set — fabricated evidence about strangers is refused.
    """

    def __init__(self, db, chain_id: str):
        self._db = db
        self._chain_id = chain_id
        self._lock = threading.Lock()
        self._pending: dict[bytes, DuplicateVoteEvidence] = {}
        self._load()

    def _load(self) -> None:
        for k, v in self._db.iterate_prefix(b"ev/"):
            try:
                self._pending[k] = decode_evidence(v)
            except (ValueError, IndexError):
                log.warn("corrupt evidence entry dropped", key=k.hex())

    def verify(self, ev: DuplicateVoteEvidence, val_set) -> None:
        """Raise ValueError unless ev is a valid equivocation proof by a
        member of val_set."""
        a, b = ev.vote_a, ev.vote_b
        if (a.validator_address != b.validator_address or
                a.height != b.height or a.round != b.round or
                a.type != b.type):
            raise ValueError("votes are not for the same (val, h, r, type)")
        if a.block_id.key() == b.block_id.key():
            raise ValueError("votes agree; no equivocation")
        val = val_set.get_by_address(a.validator_address)
        if val is None:
            raise ValueError("accused validator not in the set")
        for v in (a, b):
            if not val.pub_key.verify(v.sign_bytes(self._chain_id),
                                      v.signature):
                raise ValueError("evidence vote signature invalid")

    def add(self, ev: DuplicateVoteEvidence, val_set) -> bool:
        """Verify + store; False when duplicate/invalid."""
        key = evidence_key(ev)
        with self._lock:
            if key in self._pending:
                return False
        try:
            self.verify(ev, val_set)
        except ValueError as e:
            log.warn("rejected evidence", err=str(e))
            return False
        with self._lock:
            if key in self._pending:
                return False
            self._pending[key] = ev
            self._db.set(key, encode_evidence(ev))
        log.info("evidence stored",
                 validator=ev.vote_a.validator_address.hex()[:12],
                 height=ev.vote_a.height)
        return True

    def pending(self) -> list[DuplicateVoteEvidence]:
        with self._lock:
            return list(self._pending.values())

    def size(self) -> int:
        with self._lock:
            return len(self._pending)
