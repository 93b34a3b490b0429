"""All VoteSets (prevote + precommit) for one height across rounds.

Reference: `consensus/height_vote_set.go` — lazily materialized rounds,
at most 2 peer-catchup rounds per peer (`:14-24,105-128`), POL search
(`POLInfo` `:145-157`), peer maj23 claims routed to the right round
(`SetPeerMaj23` `:205-217`).  Copy of
`tendermint_tpu/consensus/height_vote_set.py`.
"""

from __future__ import annotations

import threading

from tendermint_tpu_torch.types import TYPE_PRECOMMIT, TYPE_PREVOTE
from tendermint_tpu_torch.types.vote import VoteSet


class HeightVoteSet:
    def __init__(self, chain_id: str, height: int, val_set):
        self.chain_id = chain_id
        self.height = height
        self.val_set = val_set
        self._lock = threading.Lock()
        self._round = 0
        self._sets: dict[tuple[int, int], VoteSet] = {}
        self._peer_catchup_rounds: dict[str, list[int]] = {}
        self.set_round(0)

    def _get(self, round_: int, type_: int, create: bool = False):
        key = (round_, type_)
        vs = self._sets.get(key)
        if vs is None and create:
            vs = VoteSet(self.chain_id, self.height, round_, type_,
                         self.val_set)
            self._sets[key] = vs
        return vs

    def set_round(self, round_: int) -> None:
        """Materialize round and round+1 (reference `:58-74`)."""
        with self._lock:
            self._round = round_
            for r in (round_, round_ + 1):
                for t in (TYPE_PREVOTE, TYPE_PRECOMMIT):
                    self._get(r, t, create=True)

    def round(self) -> int:
        return self._round

    def add_vote(self, vote, peer_id: str = "", verify: bool = True) -> bool:
        """Route to the vote's round; peers may push up to 2 catchup
        rounds beyond the current one (reference `:105-128`).
        `verify=False` skips the signature check for votes the caller
        already verified in a device micro-batch (consensus receive-loop
        burst ingestion)."""
        with self._lock:
            vs = self._get(vote.round, vote.type)
            if vs is None:
                rounds = self._peer_catchup_rounds.setdefault(peer_id, [])
                if vote.round in rounds:
                    pass  # already allowed for this peer
                elif len(rounds) < 2:
                    rounds.append(vote.round)
                else:
                    raise ValueError(
                        f"peer {peer_id!r} exceeded catchup-round quota")
                vs = self._get(vote.round, vote.type, create=True)
        return vs.add_vote(vote, verify=verify)

    def prevotes(self, round_: int) -> VoteSet | None:
        with self._lock:
            return self._get(round_, TYPE_PREVOTE)

    def precommits(self, round_: int) -> VoteSet | None:
        with self._lock:
            return self._get(round_, TYPE_PRECOMMIT)

    def pol_info(self) -> tuple[int, object] | None:
        """Newest round with a prevote +2/3 (POL), searched descending
        (reference `:145-157`); returns (round, block_id) or None."""
        with self._lock:
            for r in range(self._round, -1, -1):
                vs = self._get(r, TYPE_PREVOTE)
                if vs is not None:
                    maj = vs.two_thirds_majority()
                    if maj is not None:
                        return r, maj
        return None

    def set_peer_maj23(self, round_: int, type_: int, peer_id: str,
                       block_id) -> None:
        with self._lock:
            vs = self._get(round_, type_, create=True)
        vs.set_peer_maj23(peer_id, block_id)
