"""Votes and the weighted 2/3 quorum engine.

Reference: `types/vote.go` (signed vote message) and `types/vote_set.go`
(weighted tally with conflict tracking, peer-claimed majorities, commit
extraction).  Copy of `tendermint_tpu/types/vote.py`.  The hot path, one
ed25519 verify per vote at `types/vote_set.go:175`, is split: single
votes verify scalar on the host, bulk ingestion goes through
`add_votes_batched`, which verifies a whole batch in one grouped call on
the batch plane it is given (kernel K1 with per-lane keys on
`CudaBackend`).  Unlike the JAX package, a failed batched verify is not
redone scalar: the plane's error propagates to the caller.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from tendermint_tpu_torch.types import canonical
from tendermint_tpu_torch.types.codec import Reader, lp_bytes, u32, u64, u8

# re-exported vote types
TYPE_PREVOTE = canonical.TYPE_PREVOTE
TYPE_PRECOMMIT = canonical.TYPE_PRECOMMIT


def _block_id():
    # deferred import: block.py imports Vote for Commit
    from tendermint_tpu_torch.types.block import BlockID
    return BlockID


@dataclass(frozen=True)
class Vote:
    validator_address: bytes
    validator_index: int
    height: int
    round: int
    type: int                      # TYPE_PREVOTE | TYPE_PRECOMMIT
    block_id: "object"             # BlockID; zero = nil vote
    signature: bytes = b""

    def validate_basic(self) -> None:
        """Structural checks on wire-decoded votes: every length is fixed
        so a malformed vote can never shift the sign-bytes layout or a
        batch verifier's lanes."""
        if self.type not in (TYPE_PREVOTE, TYPE_PRECOMMIT):
            raise ValueError(f"bad vote type {self.type}")
        if len(self.validator_address) != 20:
            raise ValueError("validator address must be 20 bytes")
        if self.validator_index < 0 or self.height < 1 or self.round < 0:
            raise ValueError("negative vote index/height/round")
        bid = self.block_id
        if bid.hash and len(bid.hash) != 32:
            raise ValueError("block hash must be 32 bytes or empty")
        if bid.parts.hash and len(bid.parts.hash) != 32:
            raise ValueError("parts hash must be 32 bytes or empty")
        if len(self.signature) != 64:
            raise ValueError("signature must be 64 bytes")

    def sign_bytes(self, chain_id: str) -> bytes:
        return canonical.sign_bytes(
            chain_id, self.type, self.height, self.round,
            block_hash=self.block_id.hash,
            parts_hash=self.block_id.parts.hash,
            parts_total=self.block_id.parts.total)

    def is_nil(self) -> bool:
        return self.block_id.is_zero()

    def encode(self) -> bytes:
        return (lp_bytes(self.validator_address) + u32(self.validator_index) +
                u64(self.height) + u32(self.round) + u8(self.type) +
                self.block_id.encode() + lp_bytes(self.signature))

    @classmethod
    def decode(cls, r: Reader) -> "Vote":
        BlockID = _block_id()
        return cls(validator_address=r.lp_bytes(), validator_index=r.u32(),
                   height=r.u64(), round=r.u32(), type=r.u8(),
                   block_id=BlockID.decode(r), signature=r.lp_bytes())

    def __str__(self):
        t = {1: "prevote", 2: "precommit"}.get(self.type, f"t{self.type}")
        tgt = "nil" if self.is_nil() else self.block_id.hash.hex()[:12]
        return (f"Vote[{self.validator_index}:"
                f"{self.validator_address.hex()[:8]} {self.height}/"
                f"{self.round} {t} -> {tgt}]")


@dataclass(frozen=True)
class DuplicateVoteEvidence:
    """Proof of equivocation: two different votes for the same (validator,
    height, round, type) (reference `types/vote_set.go:195-211`)."""
    vote_a: Vote
    vote_b: Vote


class ErrVoteConflict(Exception):
    def __init__(self, evidence: DuplicateVoteEvidence):
        super().__init__("conflicting votes (equivocation)")
        self.evidence = evidence


class _BlockVotes:
    """Tally for one BlockID within a VoteSet
    (reference `types/vote_set.go:66-80,417-443`)."""

    __slots__ = ("peer_maj23", "bit_array", "votes", "sum")

    def __init__(self, n: int, peer_maj23: bool):
        self.peer_maj23 = peer_maj23
        self.bit_array = [False] * n
        self.votes: list[Vote | None] = [None] * n
        self.sum = 0

    def add_verified(self, idx: int, vote: Vote, power: int):
        if self.votes[idx] is None:
            self.bit_array[idx] = True
            self.votes[idx] = vote
            self.sum += power


def batch_verify_vote_sigs(chain_id: str, val_set, votes,
                           plane) -> np.ndarray:
    """ONE grouped signature check for votes by members of `val_set` —
    the shared lane assembly under both `VoteSet.add_votes_batched` and
    the consensus receive loop's burst pre-verify.

    Caller guarantees every vote passed `validate_basic` and that
    `val_set.validators[v.validator_index].address` matches — this
    function checks signatures only.  Nil-vote hashes are zero-padded to
    the fixed 32-byte rows `batch_sign_bytes` documents, so prevotes and
    precommits alike are `SIGN_BYTES_LEN`-byte rows and bursts from many
    nodes merge into one launch.  Returns bool[N].

    Lanes ride `plane` at the CONSENSUS class — the highest priority: a
    vote burst preempts any queued light-client or CheckTx batch, and
    the plane may coalesce it with other verify work for this validator
    set already queued.  An error of the flush is raised here.
    """
    from tendermint_tpu_torch.batchplane import CLASS_CONSENSUS
    n = len(votes)
    if n == 0:
        return np.zeros(0, dtype=bool)
    msgs = canonical.batch_sign_bytes(
        chain_id,
        np.asarray([v.type for v in votes], dtype=np.uint8),
        np.asarray([v.height for v in votes], dtype=np.uint64),
        np.asarray([v.round for v in votes], dtype=np.uint32),
        np.frombuffer(b"".join(v.block_id.hash.ljust(32, b"\x00")
                               for v in votes), np.uint8).reshape(n, 32),
        np.frombuffer(b"".join(v.block_id.parts.hash.ljust(32, b"\x00")
                               for v in votes), np.uint8).reshape(n, 32),
        np.asarray([v.block_id.parts.total for v in votes],
                   dtype=np.uint32))
    return plane.verify_grouped(
        val_set.set_key(), val_set.pubs_matrix(),
        np.asarray([v.validator_index for v in votes], dtype=np.int32),
        msgs,
        np.frombuffer(b"".join(v.signature for v in votes),
                      np.uint8).reshape(n, 64),
        producer="consensus", klass=CLASS_CONSENSUS)


class VoteSet:
    """All votes of one (height, round, type) weighted by validator power
    (reference `types/vote_set.go:46-288`).

    Conflict rule: the first vote per validator counts toward its block's
    sum; a conflicting second vote raises ErrVoteConflict (evidence) but is
    still tracked, and counts for a block once some peer claims a 2/3
    majority for that block via `set_peer_maj23` — exactly the reference's
    byzantine-tolerant accounting.
    """

    def __init__(self, chain_id: str, height: int, round_: int, type_: int,
                 val_set):
        assert height >= 1
        self.chain_id = chain_id
        self.height = height
        self.round = round_
        self.type = type_
        self.val_set = val_set
        n = val_set.size()
        self._votes: list[Vote | None] = [None] * n        # canonical votes
        self._sum = 0                                      # power of _votes
        self._maj23: object | None = None                  # BlockID once hit
        self._votes_by_block: dict[tuple, _BlockVotes] = {}
        self._peer_maj23s: dict[str, object] = {}

    # -- sizing ---------------------------------------------------------
    def size(self) -> int:
        return self.val_set.size()

    # -- ingestion ------------------------------------------------------
    def add_vote(self, vote: Vote, verify: bool = True) -> bool:
        """Returns True if the vote was added, False if duplicate/irrelevant.
        Raises ErrVoteConflict on equivocation, ValueError on bad votes
        (reference `types/vote_set.go:126-194`)."""
        if vote is None:
            raise ValueError("nil vote")
        vote.validate_basic()
        if (vote.height != self.height or vote.round != self.round or
                vote.type != self.type):
            raise ValueError(
                f"vote {vote} does not match VoteSet "
                f"{self.height}/{self.round}/{self.type}")
        idx = vote.validator_index
        if not (0 <= idx < self.size()):
            raise ValueError(f"validator index {idx} out of range")
        val = self.val_set.validators[idx]
        if val.address != vote.validator_address:
            raise ValueError("vote address does not match validator index")
        existing = self._votes[idx]
        if existing is not None and \
                existing.block_id.key() == vote.block_id.key():
            return False  # exact duplicate
        if verify:
            ok = val.pub_key.verify(vote.sign_bytes(self.chain_id),
                                    vote.signature)
            if not ok:
                raise ValueError(f"invalid signature on {vote}")
        return self._add_verified(vote, val.voting_power)

    def add_votes_batched(self, votes: list[Vote],
                          plane) -> list[bool | Exception]:
        """Bulk ingestion: one grouped verify of every checkable
        signature on `plane`, then sequential accounting.  Returns the
        per-vote outcome.  An error of the verify (a failed K1 build or
        launch) propagates: no vote is counted."""
        if not votes:
            return []
        sel, checkable = [], []
        for i, v in enumerate(votes):
            try:
                v.validate_basic()
            except ValueError:
                continue  # malformed: must not poison the batch lanes
            idx = v.validator_index
            if (v.height == self.height and v.round == self.round and
                    v.type == self.type and idx < self.size() and
                    self.val_set.validators[idx].address ==
                    v.validator_address):
                sel.append(v)
                checkable.append(i)
        ok = np.zeros(len(votes), dtype=bool)
        if checkable:
            ok[np.array(checkable)] = batch_verify_vote_sigs(
                self.chain_id, self.val_set, sel, plane)
        out: list[bool | Exception] = []
        for i, v in enumerate(votes):
            if not ok[i]:
                out.append(ValueError(f"invalid vote/signature {v}"))
                continue
            try:
                out.append(self.add_vote(v, verify=False))
            except (ValueError, ErrVoteConflict) as e:
                out.append(e)
        return out

    def _add_verified(self, vote: Vote, power: int) -> bool:
        idx = vote.validator_index
        key = vote.block_id.key()
        existing = self._votes[idx]
        conflict: ErrVoteConflict | None = None
        if existing is None:
            self._votes[idx] = vote
            self._sum += power
        else:
            conflict = ErrVoteConflict(DuplicateVoteEvidence(existing, vote))
            # if the conflicting vote is for the established maj23 block,
            # promote it into the canonical array so make_commit always
            # carries the full +2/3 (reference `types/vote_set.go:219-223`)
            if self._maj23 is not None and self._maj23.key() == key:
                self._votes[idx] = vote
        bv = self._votes_by_block.get(key)
        if bv is None:
            if conflict is not None:
                # conflicting vote for an untracked block: forget it rather
                # than allocate — a byzantine validator signing many distinct
                # hashes must not grow memory (reference vote_set.go:241-244)
                raise conflict
            bv = _BlockVotes(self.size(), peer_maj23=False)
            self._votes_by_block[key] = bv
        elif conflict is not None and not bv.peer_maj23:
            raise conflict
        bv.add_verified(idx, vote, power)
        self._update_maj23(key, vote)
        if conflict is not None:
            raise conflict
        return True

    def _update_maj23(self, key: tuple, vote: Vote):
        bv = self._votes_by_block[key]
        if (self._maj23 is None and
                bv.sum * 3 > self.val_set.total_voting_power() * 2):
            self._maj23 = vote.block_id
            # copy this block's votes over the canonical array so conflicting
            # votes that formed the majority are extractable by make_commit
            # (reference `types/vote_set.go:267-271`)
            for i, v in enumerate(bv.votes):
                if v is not None:
                    self._votes[i] = v

    def set_peer_maj23(self, peer_id: str, block_id) -> None:
        """A peer claims 2/3 for block_id: start counting conflicting votes
        toward it (reference `types/vote_set.go:290-323`)."""
        key = block_id.key()
        prev = self._peer_maj23s.get(peer_id)
        if prev is not None and prev.key() != key:
            raise ValueError(f"peer {peer_id} sent conflicting maj23 claims")
        self._peer_maj23s[peer_id] = block_id
        bv = self._votes_by_block.get(key)
        if bv is None:
            bv = _BlockVotes(self.size(), peer_maj23=True)
            self._votes_by_block[key] = bv
            return
        if bv.peer_maj23:
            return
        bv.peer_maj23 = True
        # recount: canonical votes for this block are already there; future
        # conflicting votes for it are added on arrival

    # -- queries --------------------------------------------------------
    def get_by_index(self, idx: int) -> Vote | None:
        return self._votes[idx]

    def get_by_address(self, addr: bytes) -> Vote | None:
        idx = self.val_set.index_of(addr)
        return self._votes[idx] if idx >= 0 else None

    def bit_array(self) -> list[bool]:
        return [v is not None for v in self._votes]

    def bit_array_by_block_id(self, block_id) -> list[bool]:
        bv = self._votes_by_block.get(block_id.key())
        return list(bv.bit_array) if bv else [False] * self.size()

    def sum(self) -> int:
        return self._sum

    def has_two_thirds_majority(self) -> bool:
        return self._maj23 is not None

    def two_thirds_majority(self):
        """BlockID (possibly zero = nil) if 2/3 of power agrees, else None
        (reference `types/vote_set.go:254-274`)."""
        return self._maj23

    def has_two_thirds_any(self) -> bool:
        return self._sum * 3 > self.val_set.total_voting_power() * 2

    def has_one_third_any(self) -> bool:
        return self._sum * 3 > self.val_set.total_voting_power()

    def has_all(self) -> bool:
        return self._sum == self.val_set.total_voting_power()

    def make_commit(self):
        """Extract a Commit once 2/3 precommitted a non-nil block
        (reference `types/vote_set.go:455-474`)."""
        from tendermint_tpu_torch.types.block import Commit
        if self.type != TYPE_PRECOMMIT:
            raise ValueError("cannot make commit from non-precommit VoteSet")
        if self._maj23 is None or self._maj23.is_zero():
            raise ValueError("no +2/3 majority for a block")
        key = self._maj23.key()
        precommits: list[Vote | None] = []
        for v in self._votes:
            if v is not None and v.block_id.key() == key:
                precommits.append(v)
            else:
                precommits.append(None)
        return Commit(block_id=self._maj23, precommits=precommits)

    def __str__(self):
        t = {1: "prevote", 2: "precommit"}.get(self.type, f"t{self.type}")
        return (f"VoteSet[{self.height}/{self.round}/{t} "
                f"{self._sum}/{self.val_set.total_voting_power()}]")
