"""Validators, the validator set, and batched commit verification.

Reference: `types/validator.go`, `types/validator_set.go` — address-sorted
validator array with voting power, accumulated-priority proposer rotation
(`:52-69`), Merkle hash over validators (`:140-149`), and `VerifyCommit`
(`:220-264`) — THE fast-sync hot loop (reference
`blockchain/reactor.go:230-231`): ~N ed25519 verifies per block, done here
as one crypto-backend batch instead of a scalar loop.

Copy of `tendermint_tpu/types/validator.py`; the batch plane is not part
of the port yet, so verification takes its crypto backend explicitly.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from tendermint_tpu_torch.types import canonical, merkle
from tendermint_tpu_torch.types.codec import Reader, i64, lp_bytes, u32
from tendermint_tpu_torch.types.keys import PubKey


class CommitSignatureError(ValueError):
    """A commit carries an invalid signature.  In fast-sync the commit for
    height h travels in block h+1's LastCommit, so the *successor's*
    deliverer is at fault."""

    def __init__(self, height: int, lane: int):
        super().__init__(
            f"invalid commit signature at height {height} (lane {lane})")
        self.height = height
        self.lane = lane


class CommitPowerError(ValueError):
    """A commit's tallied power for the expected block is below +2/3.

    `foreign_votes` disambiguates the two causes so fast-sync blames the
    right deliverer: True = verified votes endorse a DIFFERENT non-nil
    block, i.e. the block at `height` itself is not what the network
    committed (its deliverer lied); False = every vote endorses our
    block but too few are present — the commit (carried by the SUCCESSOR
    block's LastCommit) was pruned, so height+1's deliverer lied."""

    def __init__(self, height: int, tallied: int, total: int,
                 foreign_votes: bool = True):
        super().__init__(
            f"insufficient voting power at height {height}: "
            f"{tallied}/{total}"
            f"{' (votes for another block)' if foreign_votes else ''}")
        self.height = height
        self.foreign_votes = foreign_votes


class CommitFormatError(ValueError):
    """A commit is structurally unusable as the +2/3 proof for `height`:
    wrong height (a STALE finality proof replayed from an older block),
    wrong size, or malformed votes.  Like a pruned commit it rides in the
    successor block's LastCommit, so height+1's deliverer is at fault —
    without this mapping a replayed stale commit would raise a bare
    ValueError that fast-sync can only log, stalling the pool forever
    instead of evicting the liar."""

    def __init__(self, height: int, detail: str):
        super().__init__(
            f"unusable commit for height {height}: {detail}")
        self.height = height


@dataclass
class Validator:
    pub_key: PubKey
    voting_power: int
    accum: int = 0

    @property
    def address(self) -> bytes:
        return self.pub_key.address

    @property
    def sort_key(self) -> bytes:
        """Cached `_neg_addr(address)` — the proposer-rotation tie-break
        runs V comparisons per block, so this is per-block hot."""
        k = self.__dict__.get("_sort_key")
        if k is None:
            k = self.__dict__["_sort_key"] = _neg_addr(self.address)
        return k

    def copy(self) -> "Validator":
        v = Validator(self.pub_key, self.voting_power, self.accum)
        if "_sort_key" in self.__dict__:
            v.__dict__["_sort_key"] = self.__dict__["_sort_key"]
        return v

    def encode(self) -> bytes:
        return (lp_bytes(self.pub_key.bytes_) + i64(self.voting_power) +
                i64(self.accum))

    @classmethod
    def decode(cls, r: Reader) -> "Validator":
        return cls(pub_key=PubKey(r.lp_bytes()), voting_power=r.i64(),
                   accum=r.i64())

    def hash_bytes(self) -> bytes:
        """The bytes committed into the validators hash."""
        return lp_bytes(self.pub_key.bytes_) + i64(self.voting_power)

    def __str__(self):
        return f"Val[{self.address.hex()[:8]} pow {self.voting_power}]"


class ValidatorSet:
    """Address-sorted validators with proposer rotation
    (reference `types/validator_set.go:20-69`)."""

    def __init__(self, validators: list[Validator]):
        vals = sorted((v.copy() for v in validators),
                      key=lambda v: v.address)
        addrs = [v.address for v in vals]
        if len(set(addrs)) != len(addrs):
            raise ValueError("duplicate validator address")
        self.validators = vals
        self._total = sum(v.voting_power for v in vals)
        self._by_addr = {v.address: i for i, v in enumerate(vals)}
        self._proposer: Validator | None = None
        # accumulated priorities live in THIS ARRAY, not on the Validator
        # objects (v.accum is a construction-time input / decode field
        # only): rotation happens every block and every round, and
        # array-residency makes increment_accum pure numpy and copy() an
        # array copy instead of V object allocations — the two were ~18%
        # of the fast-sync apply stage at V=100
        self._accums = np.fromiter((v.accum for v in vals), np.int64,
                                   len(vals))
        if vals:
            self.increment_accum(1)

    def accum_of(self, i: int) -> int:
        """Accumulated priority of validators[i] (authoritative — the
        objects' .accum fields are not updated by rotation)."""
        return int(self._accums[i])

    # -- basics ---------------------------------------------------------
    def size(self) -> int:
        return len(self.validators)

    def total_voting_power(self) -> int:
        return self._total

    def index_of(self, address: bytes) -> int:
        return self._by_addr.get(address, -1)

    def get_by_address(self, address: bytes) -> Validator | None:
        i = self.index_of(address)
        return self.validators[i] if i >= 0 else None

    def has_address(self, address: bytes) -> bool:
        return address in self._by_addr

    def copy(self) -> "ValidatorSet":
        """O(1)-ish copy: Validator objects are immutable after set
        construction (rotation state lives in `_accums`; `apply_updates`
        replaces objects copy-on-write), so copies SHARE them — only the
        accum array, the list, and the index dict are duplicated."""
        new = ValidatorSet.__new__(ValidatorSet)
        new.validators = list(self.validators)
        new._total = self._total
        new._by_addr = dict(self._by_addr)
        new._proposer = self._proposer
        new._accums = self._accums.copy()
        # membership-derived caches survive a copy (invalidated only by
        # apply_updates); the hash also survives accum rotation because
        # hash_bytes excludes accum
        for attr in ("_set_key", "_pubs_mat", "_addr_mat", "_hash",
                     "_powers", "_enc"):
            if attr in self.__dict__:
                new.__dict__[attr] = self.__dict__[attr]
        return new

    # -- proposer rotation ---------------------------------------------
    def _powers_arr(self) -> np.ndarray:
        p = self.__dict__.get("_powers")
        if p is None:
            p = self.__dict__["_powers"] = np.array(
                [v.voting_power for v in self.validators], dtype=np.int64)
        return p

    def increment_accum(self, times: int) -> None:
        """Accumulated-priority rotation (reference
        `types/validator_set.go:52-69`): each step every validator gains
        accum += power; the max-accum validator (ties: lowest address)
        becomes proposer and pays total power.

        Vectorized: the per-step Python max over (accum, sort_key)
        tuples was ~0.2 ms/block at V=100 — a leading slice of the
        fast-sync apply stage (VERDICT r4 #5).  numpy argmax decides;
        the byte-string tie-break only runs on actual accum ties
        (equal-power sets at specific heights)."""
        vals = self.validators
        powers = self._powers_arr()
        accums = self._accums
        for _ in range(times):
            accums += powers
            i = int(np.argmax(accums))
            ties = np.flatnonzero(accums == accums[i])
            if len(ties) > 1:
                i = max((int(t) for t in ties),
                        key=lambda t: vals[t].sort_key)
            accums[i] -= self._total
            self._proposer = vals[i]
        self.__dict__.pop("_enc", None)    # accum is part of encode()

    @property
    def proposer(self) -> Validator:
        assert self._proposer is not None
        return self._proposer

    # -- hashing / codec ------------------------------------------------
    def hash(self) -> bytes:
        """Merkle root over validators (reference
        `types/validator_set.go:140-149`).  Cached: recomputing this tree
        per block was ~1/3 of fast-sync apply; accum rotation does not
        change it (hash_bytes excludes accum), only apply_updates does."""
        h = self.__dict__.get("_hash")
        if h is None:
            h = self.__dict__["_hash"] = merkle.root(
                [v.hash_bytes() for v in self.validators])
        return h

    def set_key(self) -> bytes:
        """Stable identity for crypto-backend table caching: a digest of
        the MEMBER PUBKEYS only — comb tables depend on keys, not powers,
        so a power-only EndBlock diff must not force a table rebuild."""
        k = getattr(self, "_set_key", None)
        if k is None:
            import hashlib
            k = self._set_key = hashlib.sha256(
                self.pubs_matrix().tobytes()).digest()
        return k

    def pubs_matrix(self) -> np.ndarray:
        """uint8[V, 32] of member pubkeys in validator order — the
        fixed key set handed to Backend.verify_grouped."""
        m = getattr(self, "_pubs_mat", None)
        if m is None:
            m = np.frombuffer(
                b"".join(v.pub_key.bytes_ for v in self.validators),
                np.uint8).reshape(len(self.validators), 32)
            self._pubs_mat = m
        return m

    def address_matrix(self) -> np.ndarray:
        """uint8[V, 20] of member addresses in validator order (a block
        store writes them into every stored commit's votes)."""
        m = self.__dict__.get("_addr_mat")
        if m is None:
            m = self.__dict__["_addr_mat"] = np.frombuffer(
                b"".join(v.address for v in self.validators),
                np.uint8).reshape(len(self.validators), 20)
        return m

    def encode(self) -> bytes:
        """Vectorized assembly: the state layer persists BOTH valsets on
        every committed block, so a per-validator Python loop (~200 calls
        at V=100) is real per-block cost in fast-sync replay.  Entries are
        fixed 52-byte rows (u32 len=32 || pub32 || i64 power || i64 accum)
        built in one numpy buffer.  Cached until accum/membership changes
        (state persistence encodes the same set up to three times per
        committed block: state.validators, the height-keyed history row,
        and next block's last_validators)."""
        e = self.__dict__.get("_enc")
        if e is not None:
            return e
        n = len(self.validators)
        rows = np.zeros((n, 52), dtype=np.uint8)
        rows[:, 0:4] = np.frombuffer(u32(32) * n,
                                     np.uint8).reshape(n, 4)
        rows[:, 4:36] = self.pubs_matrix()
        rows[:, 36:44] = np.asarray(
            [v.voting_power for v in self.validators],
            dtype=">i8").view(np.uint8).reshape(n, 8)
        rows[:, 44:52] = self._accums.astype(
            ">i8").view(np.uint8).reshape(n, 8)
        prop = self.index_of(self._proposer.address) if self._proposer else -1
        e = self.__dict__["_enc"] = u32(n) + rows.tobytes() + i64(prop)
        return e

    @classmethod
    def decode(cls, r: Reader) -> "ValidatorSet":
        n = r.u32()
        vals = [Validator.decode(r) for _ in range(n)]
        prop = r.i64()
        vs = cls.__new__(cls)
        vs.validators = vals   # already sorted when encoded
        vs._total = sum(v.voting_power for v in vals)
        vs._by_addr = {v.address: i for i, v in enumerate(vals)}
        vs._proposer = vals[prop] if 0 <= prop < len(vals) else None
        vs._accums = np.fromiter((v.accum for v in vals), np.int64,
                                 len(vals))
        return vs

    # -- membership updates (ABCI EndBlock diffs) ------------------------
    def apply_updates(self, changes: list[tuple[bytes, int]]) -> None:
        """(pubkey, power) diffs; power 0 removes (reference
        `state/execution.go:117-156` updateValidators).

        COPY-ON-WRITE on the touched validators: objects are shared
        between set copies (see `copy`), so a power change replaces the
        object instead of mutating it.  Surviving validators keep their
        accumulated priority (from this set's array); new entrants start
        at 0 — the reference's semantics."""
        accums = {v.address: int(a)
                  for v, a in zip(self.validators, self._accums)}
        vals = {v.address: v for v in self.validators}
        for pub, power in changes:
            pk = PubKey(pub)
            addr = pk.address
            if power < 0:
                raise ValueError("negative voting power")
            if power == 0:
                if addr not in vals:
                    raise ValueError("removing unknown validator")
                del vals[addr]
            else:
                vals[addr] = Validator(pk, power)
                accums.setdefault(addr, 0)   # survivors keep theirs
        self.validators = sorted(vals.values(), key=lambda v: v.address)
        self._accums = np.fromiter(
            (accums[v.address] for v in self.validators), np.int64,
            len(self.validators))
        self._total = sum(v.voting_power for v in self.validators)
        self._by_addr = {v.address: i for i, v in enumerate(self.validators)}
        self._set_key = None     # membership/power changed: invalidate
        self._pubs_mat = None    # the grouped-verify identity + key matrix
        self.__dict__.pop("_addr_mat", None)
        self.__dict__.pop("_hash", None)
        self.__dict__.pop("_enc", None)
        self.__dict__.pop("_powers", None)
        if (self._proposer is not None and
                self._proposer.address not in self._by_addr):
            self._proposer = None
        elif self._proposer is not None:
            # re-point at the (possibly replaced copy-on-write) object in
            # self.validators — a re-powered proposer must not linger as
            # the stale pre-update object
            self._proposer = self.validators[
                self._by_addr[self._proposer.address]]
        if self._proposer is None and self.validators:
            self.increment_accum(1)

    # -- commit verification (the TPU hot path) --------------------------
    def commit_verify_arrays(self, chain_id: str, block_id, height: int,
                             commit) -> tuple:
        """Flatten a commit into verify arrays so callers can batch many
        commits into one device call.

        Returns (pubs[N,32], msgs[N,128], sigs[N,64], powers[N], idxs[N])
        covering EVERY non-nil precommit at (height, commit.round) — all
        signatures must verify, matching the reference's VerifyCommit which
        rejects a commit carrying any invalid signature — with powers[i] = 0
        for precommits voting a different block (verified but not tallied)
        and idxs[i] the signer's validator index (grouped-verify lane map).
        A structural error in any precommit raises ValueError.

        Derived from `commit_verify_lanes` — the per-vote validation
        lives in exactly one place — by expanding the message templates.
        """
        templates, tmpl_idx, sigs, powers, idxs, _ = \
            self.commit_verify_lanes(chain_id, block_id, height, commit)
        return (self.pubs_matrix()[idxs], templates[tmpl_idx], sigs,
                powers, idxs)

    def commit_verify_lanes(self, chain_id: str, block_id, height: int,
                            commit) -> tuple:
        """Template form of `commit_verify_arrays`: vote sign-bytes do
        not include the signer, so lanes voting the same block share ONE
        128-byte message — a commit compresses to ~1 template plus
        per-lane (sig, validator index, template index).  Device backends
        ship only the indices and assemble messages on device.

        Returns (templates[T,128], tmpl_idx[N], sigs[N,64], powers[N],
        idxs[N], foreign_power int) — foreign_power totals the voting
        power of lanes endorsing a different NON-NIL block (the blame
        disambiguator for CommitPowerError: a single Byzantine stray
        vote must not redirect fast-sync blame when the real defect is a
        pruned LastCommit).
        """
        from tendermint_tpu_torch.types.block import CompactCommit
        if isinstance(commit, CompactCommit):
            return self._compact_commit_lanes(chain_id, block_id, height,
                                              commit)
        if self.size() != commit.size():
            raise ValueError(
                f"commit size {commit.size()} != valset size {self.size()}")
        if commit.height() != height:
            raise ValueError(f"commit height {commit.height()} != {height}")
        round_ = commit.round()
        bid_key = block_id.key()
        tmpl_of: dict[tuple, int] = {}
        templates: list[bytes] = []
        tmpl_idx, sigs, powers, idxs = [], [], [], []
        foreign_power = 0
        for idx, v in enumerate(commit.precommits):
            if v is None:
                continue
            try:
                v.validate_basic()   # fixed lengths: no lane misalignment
            except ValueError as e:
                raise ValueError(f"commit vote {idx}: {e}") from None
            if v.type != canonical.TYPE_PRECOMMIT:
                raise ValueError(f"commit vote {idx} not a precommit")
            if v.height != height or v.round != round_:
                raise ValueError(f"commit vote {idx} wrong height/round")
            if v.validator_index != idx:
                raise ValueError(
                    f"commit vote index {v.validator_index}!={idx}")
            val = self.validators[idx]
            if val.address != v.validator_address:
                raise ValueError(f"commit vote {idx} address mismatch")
            vkey = v.block_id.key()
            ti = tmpl_of.get(vkey)
            if ti is None:
                ti = tmpl_of[vkey] = len(templates)
                templates.append(v.sign_bytes(chain_id))
            tmpl_idx.append(ti)
            sigs.append(v.signature)
            if vkey == bid_key:
                powers.append(val.voting_power)
            else:
                powers.append(0)
                if not v.block_id.is_zero():
                    foreign_power += val.voting_power
            idxs.append(idx)
        n = len(idxs)
        return (
            np.frombuffer(b"".join(templates), np.uint8).reshape(
                len(templates), canonical.SIGN_BYTES_LEN),
            np.asarray(tmpl_idx, dtype=np.int32),
            np.frombuffer(b"".join(sigs), np.uint8).reshape(n, 64),
            np.asarray(powers, dtype=np.int64),
            np.asarray(idxs, dtype=np.int32),
            foreign_power,
        )

    def _compact_commit_lanes(self, chain_id: str, block_id, height: int,
                              cc) -> tuple:
        """`commit_verify_lanes` for the array-native `CompactCommit`:
        the per-vote Python loop collapses to numpy — every present lane
        shares the commit's (height, round, block_id), so there is ONE
        template, the sigs matrix slices directly into lanes, and powers
        come from the cached power array.  Same return contract and the
        same strictness (shape checks replace per-vote field checks —
        fixed-width arrays cannot misalign lanes)."""
        cc.validate_basic()
        if self.size() != cc.size():
            raise ValueError(
                f"commit size {cc.size()} != valset size {self.size()}")
        if cc.height() != height:
            raise ValueError(f"commit height {cc.height()} != {height}")
        tmpl = canonical.sign_bytes(
            chain_id, canonical.TYPE_PRECOMMIT, height, cc.round(),
            block_hash=cc.block_id.hash,
            parts_hash=cc.block_id.parts.hash,
            parts_total=cc.block_id.parts.total)
        idxs = np.flatnonzero(cc.present).astype(np.int32)
        sigs = np.ascontiguousarray(cc.sigs[idxs])
        n = len(idxs)
        if cc.block_id.key() == block_id.key():
            powers = self._powers_arr()[idxs]
            foreign_power = 0
        else:   # the whole commit endorses another (or nil) block
            powers = np.zeros(n, dtype=np.int64)
            foreign_power = (0 if cc.block_id.is_zero()
                             else int(self._powers_arr()[idxs].sum()))
        return (np.frombuffer(tmpl, np.uint8).reshape(
                    1, canonical.SIGN_BYTES_LEN),
                np.zeros(n, dtype=np.int32), sigs,
                powers.astype(np.int64), idxs, foreign_power)

    def verify_commit(self, chain_id: str, block_id, height: int,
                      commit, backend) -> None:
        """Raise unless +2/3 of this set signed block_id at height
        (reference `types/validator_set.go:220-264`); signatures checked in
        one grouped `backend` call against this set's cached comb tables."""
        templates, tmpl_idx, sigs, powers, idxs, foreign_power = \
            self.commit_verify_lanes(chain_id, block_id, height, commit)
        # the caller hands the backend in (the handshake, restore, light
        # bisection); a plane caller passes its plane, which has this method
        # tmlint: disable=batchplane-producer
        ok = backend.verify_grouped_templated(
            self.set_key(), self.pubs_matrix(), idxs, tmpl_idx,
            templates, sigs)
        if not ok.all():
            raise CommitSignatureError(height, int(np.argmin(ok)))
        tallied = int(powers.sum())
        if not tallied * 3 > self._total * 2:
            raise CommitPowerError(
                height, tallied, self._total,
                _foreign_explains_shortfall(tallied, foreign_power,
                                            self._total))

    def __str__(self):
        return (f"ValidatorSet[{self.size()} vals, "
                f"power {self._total}]")


def merge_commit_lanes(arrays: list[tuple]) -> tuple:
    """Concatenate per-commit `commit_verify_lanes` tuples into one
    device batch, rebasing each commit's template indices onto the
    combined template block.  Returns (templates, tmpl_idx, sigs, idxs).
    """
    t_off, offs = 0, []
    for a in arrays:
        offs.append(t_off)
        t_off += len(a[0])
    return (np.concatenate([a[0] for a in arrays]),
            np.concatenate([a[1] + o for a, o in zip(arrays, offs)]),
            np.concatenate([a[2] for a in arrays]),
            np.concatenate([a[4] for a in arrays]))


def _window_fast_eligible(val_set: ValidatorSet, items: list[tuple]) -> bool:
    """True when every commit in the window satisfies, by inspection, all
    preconditions the per-block `_compact_commit_lanes` checks — so the
    vectorized pass below cannot diverge from the loop it replaces.  Any
    violation (or any object-form commit) routes to the per-block path,
    which raises the canonical error with the canonical message."""
    from tendermint_tpu_torch.types.block import CompactCommit
    v = val_set.size()
    return v > 0 and all(
        isinstance(c, CompactCommit)
        and len(c.present) == v
        and c.height_ == h
        and c.sigs.shape == (v, 64)
        and len(c.block_id.hash) == 32
        and len(c.block_id.parts.hash) == 32
        for _bid, h, c in items)


def window_commit_lanes(val_set: ValidatorSet, chain_id: str,
                        items: list[tuple]) -> tuple:
    """Window-level lane builder: the vectorized fusion of per-block
    `commit_verify_lanes` + `merge_commit_lanes` over a whole fast-sync
    window (`items` = [(block_id, height, commit)]).

    The per-block loop is the replay pipeline's scalar tail: 625 rounds
    of sign-bytes assembly, flatnonzero, sig-slice copies, and a 625-way
    concatenate, all holding the GIL inside the prep stage.  When every
    commit is an array-native `CompactCommit` (the form fast-sync
    stores), the whole window collapses to one `batch_sign_bytes` call,
    one boolean-matrix nonzero, and one fancy-indexed sig gather —
    byte-identical to the loop (property-tested), a couple of numpy
    passes instead of ~6 x B Python-level array ops.  Any object-form
    commit or precondition violation falls back to the per-block path so
    results and errors match exactly.

    Returns (templates[T,128], tmpl_idx[N], sigs[N,64], idxs[N],
    counts[B], tallied[B], foreign[B]): the first four are the merged
    device batch exactly as `merge_commit_lanes` lays it out; the last
    three are per-block lane counts, tallied power for the expected
    block, and foreign (other non-nil block) power — everything the
    post-verify tally needs, with no per-block arrays retained.
    Structural errors raise `CommitFormatError` naming the height.
    """
    if not items:
        z = np.zeros(0, dtype=np.int64)
        return (np.zeros((0, canonical.SIGN_BYTES_LEN), dtype=np.uint8),
                np.zeros(0, dtype=np.int32),
                np.zeros((0, 64), dtype=np.uint8),
                np.zeros(0, dtype=np.int32), z, z.copy(), z.copy())
    if not _window_fast_eligible(val_set, items):
        arrays = []
        for bid, h, c in items:
            try:
                arrays.append(
                    val_set.commit_verify_lanes(chain_id, bid, h, c))
            except ValueError as e:
                # stale/malformed commit: surface the height so the
                # caller can blame the successor's deliverer
                raise CommitFormatError(h, str(e)) from None
        templates, tmpl_idx, sigs, idxs = merge_commit_lanes(arrays)
        counts = np.asarray([len(a[4]) for a in arrays], dtype=np.int64)
        tallied = np.asarray([int(a[3].sum()) for a in arrays],
                             dtype=np.int64)
        foreign = np.asarray([a[5] for a in arrays], dtype=np.int64)
        return templates, tmpl_idx, sigs, idxs, counts, tallied, foreign
    b = len(items)
    heights = np.fromiter((c.height_ for _, _, c in items), np.int64, b)
    rounds = np.fromiter((c.round_ for _, _, c in items), np.int64, b)
    totals = np.fromiter((c.block_id.parts.total for _, _, c in items),
                         np.int64, b)
    bh = np.frombuffer(b"".join(c.block_id.hash for _, _, c in items),
                       np.uint8).reshape(b, 32)
    ph = np.frombuffer(b"".join(c.block_id.parts.hash for _, _, c in items),
                       np.uint8).reshape(b, 32)
    templates = canonical.batch_sign_bytes(
        chain_id, np.full(b, canonical.TYPE_PRECOMMIT, dtype=np.int64),
        heights, rounds, bh, ph, totals)
    present = np.stack([c.present for _, _, c in items])    # bool[B,V]
    # row-major nonzero == per-block flatnonzero, already in merge order
    lane_b, lane_v = np.nonzero(present)
    idxs = lane_v.astype(np.int32)
    tmpl_idx = lane_b.astype(np.int32)   # one template per compact commit
    all_sigs = np.stack([c.sigs for _, _, c in items])      # uint8[B,V,64]
    sigs = np.ascontiguousarray(all_sigs[lane_b, lane_v])
    counts = present.sum(axis=1, dtype=np.int64)
    powers = np.where(present, val_set._powers_arr()[np.newaxis, :], 0)
    row_power = powers.sum(axis=1, dtype=np.int64)
    same = np.fromiter(
        (c.block_id.key() == bid.key() for bid, _, c in items), bool, b)
    # validate_basic already rejects nil compact commits, so every
    # non-matching commit endorses a foreign non-nil block
    tallied = np.where(same, row_power, 0)
    foreign = np.where(same, 0, row_power)
    return templates, tmpl_idx, sigs, idxs, counts, tallied, foreign


def window_tally_check(items: list[tuple], ok: np.ndarray,
                       counts: np.ndarray, tallied: np.ndarray,
                       foreign: np.ndarray, total: int) -> None:
    """Post-verify window tally, vectorized: raise the canonical
    per-height error for the FIRST block (in window order) whose lanes
    fail or whose tallied power misses +2/3 — identical blame semantics
    to the per-block loop it replaces."""
    bounds = np.cumsum(counts)
    if not ok.all():
        lane = int(np.argmin(ok))
        blk = int(np.searchsorted(bounds, lane, side="right"))
        first = int(bounds[blk - 1]) if blk else 0
        h = items[blk][1]
        raise CommitSignatureError(h, int(np.argmin(ok[first:bounds[blk]])))
    short = np.flatnonzero(~(tallied * 3 > total * 2))
    if len(short):
        blk = int(short[0])
        h = items[blk][1]
        raise CommitPowerError(
            h, int(tallied[blk]), total,
            _foreign_explains_shortfall(int(tallied[blk]),
                                        int(foreign[blk]), total))


def verify_commits_batched(val_set: ValidatorSet, chain_id: str,
                           items: list[tuple], backend) -> tuple:
    """Verify MANY commits against one validator set in a single device
    call — the fast-sync window (`items` = [(block_id, height, commit)]).

    The generalization of the reference SYNC_LOOP's one-at-a-time
    `Validators.VerifyCommit` (reference `blockchain/reactor.go:230-231`):
    all (block x validator) signature lanes flatten into one grouped
    `backend` call.  Raises the canonical per-height error for the first
    failing block; returns (lanes, tallied[B]) — the lane count and the
    per-block tallied power — for the caller's accounting.
    """
    if not items:
        return 0, np.zeros(0, dtype=np.int64)
    templates, tmpl_idx, sigs, idxs, counts, tallied, foreign = \
        window_commit_lanes(val_set, chain_id, items)
    # one whole window in one grouped call on the backend the caller
    # passes (fast-sync, replay): nothing to coalesce with
    # tmlint: disable=batchplane-producer
    ok = backend.verify_grouped_templated(
        val_set.set_key(), val_set.pubs_matrix(), idxs,
        tmpl_idx, templates, sigs)
    window_tally_check(items, ok, counts, tallied, foreign,
                       val_set.total_voting_power())
    return len(idxs), tallied


def _foreign_explains_shortfall(tallied: int, foreign_power: int,
                                total: int) -> bool:
    """Blame disambiguation for CommitPowerError: only call the block
    itself foreign (redo THIS height) when the power endorsing other
    non-nil blocks is large enough that, had those votes endorsed ours,
    the commit would have reached +2/3 — a lone Byzantine stray vote
    cannot redirect blame from a pruned LastCommit (whose fix is redoing
    height+1)."""
    return (tallied + foreign_power) * 3 > total * 2


def _neg_addr(addr: bytes) -> bytes:
    """Sort helper: max() prefers the lexicographically smallest address on
    accum ties, matching the reference's deterministic tie-break."""
    return bytes(255 - b for b in addr)
