"""Light-client verification: trusted-state advancement by commits alone.

A light client holds (height, header-hash, validator set) and advances by
verifying that +2/3 of the validators it trusts signed the next header —
no block execution, no app.  Three layers:

  * `verify_commit_any` — a commit checked against BOTH an old (trusted)
    and a new (current) validator set: +2/3 of each must have signed.
    The reference declares this entry point but leaves it a stub
    (reference `types/validator_set.go:268-290`); here it is implemented
    and batched.
  * `LightClient` — sequential trusted-state follower with valset-change
    handling (the header commits to its valset via `validators_hash`,
    reference `types/block.go:178-193`).
  * `verify_chains_batched` — header+commit pairs for MANY independent
    chains verified with one grouped batch per chain, comb tables cached
    per validator set (BASELINE config 4: 1M pairs x 8 chains).

Copy of `tendermint_tpu/light/client.py`.  Every verify goes through the
`BatchPlane` the caller passes, as producer "light" in the plane's light
class: K1 against the set's comb tables, with per-lane keys and messages
for `verify_commit_any`.  The reference's one retry on a `DeviceFault`
has no counterpart: a failed build or launch propagates, and the trusted
state is left as it was.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from tendermint_tpu_torch.batchplane import CLASS_LIGHT
from tendermint_tpu_torch.types.block import BlockID, Commit, Header
from tendermint_tpu_torch.types.validator import (CommitPowerError,
                                                  CommitSignatureError,
                                                  ValidatorSet,
                                                  verify_commits_batched)

PRODUCER = "light"


class _LightRoute:
    """A plane in the shape of a backend's templated verify, each call
    submitted as the light client's (`ValidatorSet.verify_commit` and
    `verify_commits_batched` take a backend)."""

    def __init__(self, plane):
        self.plane = plane

    def verify_grouped_templated(self, set_key, val_pubs, val_idx, tmpl_idx,
                                 templates, sigs) -> np.ndarray:
        return self.plane.verify_grouped_templated(
            set_key, val_pubs, val_idx, tmpl_idx, templates, sigs,
            producer=PRODUCER, klass=CLASS_LIGHT)


@dataclass(frozen=True)
class TrustedState:
    """What a light client believes: a header it has verified and the
    validator set AUTHENTICATED at that height (it hashes to the verified
    header's `validators_hash`).  A later header signed by a different set
    is accepted only via the two-set rule (`verify_commit_any`), so the
    trust root is never seeded from unauthenticated input."""
    height: int
    header_hash: bytes
    validators: ValidatorSet


@dataclass(frozen=True)
class SignedHeader:
    header: Header
    commit: Commit

    def validate_basic(self) -> None:
        if self.commit.height() != self.header.height:
            raise ValueError(
                f"commit height {self.commit.height()} != header height "
                f"{self.header.height}")


def verify_commit_any(old_set: ValidatorSet, new_set: ValidatorSet,
                      chain_id: str, block_id: BlockID, height: int,
                      commit: Commit, plane) -> None:
    """Raise unless +2/3 of old_set AND +2/3 of new_set signed block_id.

    The commit's precommits are index-aligned with new_set (the set that
    produced it); old-set power is tallied by validator ADDRESS so the
    check survives reordering, joins, and leaves between the sets.
    Implements what the reference stubs at
    `types/validator_set.go:268-290`.  The signatures are one grouped
    verify with per-lane messages through `plane`.
    """
    _, msgs, sigs, new_powers, idxs = new_set.commit_verify_arrays(
        chain_id, block_id, height, commit)
    ok = plane.verify_grouped(new_set.set_key(), new_set.pubs_matrix(),
                              idxs, msgs, sigs, producer=PRODUCER,
                              klass=CLASS_LIGHT)
    if not ok.all():
        raise CommitSignatureError(height, int(np.argmin(ok)))
    new_tallied = int(new_powers.sum())
    if not new_tallied * 3 > new_set.total_voting_power() * 2:
        # foreign_votes=False: a light-client trust shortfall, not a
        # tampered-block claim
        raise CommitPowerError(height, new_tallied,
                               new_set.total_voting_power(),
                               foreign_votes=False)
    old_tallied = 0
    for lane, idx in enumerate(idxs):
        if new_powers[lane] == 0:     # vote for a different block
            continue
        old_val = old_set.get_by_address(new_set.validators[idx].address)
        if old_val is not None:
            old_tallied += old_val.voting_power
    if not old_tallied * 3 > old_set.total_voting_power() * 2:
        raise CommitPowerError(height, old_tallied,
                               old_set.total_voting_power(),
                               foreign_votes=False)


class LightClient:
    """Sequential trusted-state follower.

    `update` advances one signed header at a time; the caller supplies the
    header's validator set (fetched from any untrusted source — it is
    authenticated against `header.validators_hash`).  Verifies go through
    `plane`.
    """

    def __init__(self, chain_id: str, trusted: TrustedState, plane):
        self.chain_id = chain_id
        self.trusted = trusted
        self.plane = plane

    def update(self, sh: SignedHeader,
               validators: ValidatorSet) -> TrustedState:
        """Verify sh against the trusted state and advance to it.

        validators must hash to sh.header.validators_hash (its height's
        set); a valset change relative to the trusted set is accepted only
        via the two-set rule (`verify_commit_any`), so a fabricated set
        can never take over without +2/3 of the OLD set co-signing.  The
        new trusted state stores this same authenticated set — nothing
        unauthenticated ever becomes the trust root.  A failed verify
        launch raises and leaves the trusted state untouched.
        """
        sh.validate_basic()
        h = sh.header
        if h.chain_id != self.chain_id:
            raise ValueError(f"chain id {h.chain_id!r} != {self.chain_id!r}")
        if h.height != self.trusted.height + 1:
            raise ValueError(
                f"non-sequential header {h.height} after trusted "
                f"{self.trusted.height} (era client verifies sequentially)")
        if h.validators_hash != validators.hash():
            raise ValueError("supplied validator set does not match "
                             "header.validators_hash")
        if (not self.trusted.header_hash and
                h.last_block_id.hash):
            raise ValueError("first verified header must follow genesis")
        if (self.trusted.header_hash and
                h.last_block_id.hash != self.trusted.header_hash):
            raise ValueError("header.last_block_id does not point at the "
                             "trusted header")
        block_id = sh.commit.block_id
        if block_id.hash != h.hash():
            raise ValueError("commit is not for this header")
        trusted_set = self.trusted.validators
        if trusted_set.hash() == validators.hash():
            validators.verify_commit(self.chain_id, block_id, h.height,
                                     sh.commit, _LightRoute(self.plane))
        else:
            verify_commit_any(trusted_set, validators, self.chain_id,
                              block_id, h.height, sh.commit, self.plane)
        self.trusted = TrustedState(h.height, h.hash(), validators)
        return self.trusted


@dataclass
class ChainBatch:
    """One chain's slice of a multi-chain verification grid: a fixed
    validator set and many (block_id, height, commit) items."""
    chain_id: str
    validators: ValidatorSet
    items: list[tuple]        # [(BlockID, height, Commit)]


def verify_chains_batched(chains: list[ChainBatch], plane) -> None:
    """Verify MANY chains' commit batches — the multi-chain grid.

    Each chain's lanes go through one grouped verify (K1) against that
    chain's cached comb tables, so a relay or light-client hub tracking
    several chains builds tables once per (chain, valset) epoch.  Raises
    on the first failing chain (the error names its height).
    """
    route = _LightRoute(plane)
    for cb_ in chains:
        verify_commits_batched(cb_.validators, cb_.chain_id, cb_.items,
                               route)
