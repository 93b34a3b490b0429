"""Driver of the relay path: a light relay catching up on the chains it
serves.

Each step verifies one chain's header+commit pairs in one call of
`verify_chains_batched([chain], plane)` on the relay's `BatchPlane`
over the program's backend (the light class; one K1 call of the chain's
lanes against its set's comb tables, then the tally), chain after chain,
round after round.  A call is accepted, or refused with the error that
names the height and lane of a bad signature.  No per-item result is
cached on this path (the commit objects hold no hash; the backend caches
only each set's tables), so the rounds verify the same pairs again.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

from tendermint_tpu_torch.batchplane import BatchPlane
from tendermint_tpu_torch.light import ChainBatch, verify_chains_batched
from tendermint_tpu_torch.types import BlockID, CompactCommit
from tendermint_tpu_torch.types.keys import PubKey
from tendermint_tpu_torch.types.part_set import PartSetHeader
from tendermint_tpu_torch.types.validator import Validator, ValidatorSet

from bftbench.drivers import verdict
from bftbench.reference import judge

E2E = "headers_per_s"
UNITS = {E2E: "headers/s"}


@dataclass
class Call:
    chain: int
    pairs: int
    t0: float
    t1: float
    error: tuple | None = None
    spans: list = field(default_factory=list)


class Driver:
    """Verifies the chains of `traffic` (a `traffic.grid.Grid`) through a
    `BatchPlane` over `backend`."""

    def __init__(self, traffic, config: dict, backend):
        self.t = traffic
        self.backend = backend
        self.plane = BatchPlane(backend)
        self.batches = []
        for ch in traffic.chains:
            vs = ValidatorSet([Validator(PubKey(p), traffic.power)
                               for p in ch.pubs])
            present = np.ones(len(ch.pubs), bool)
            items = []
            for h in range(len(ch.hashes)):
                bid = BlockID(ch.hashes[h, 0].tobytes(),
                              PartSetHeader(1, ch.hashes[h, 1].tobytes()))
                items.append((bid, h + 1, CompactCommit(
                    bid, h + 1, 0, ch.sigs[h], present)))
            self.batches.append(ChainBatch(ch.chain_id, vs, items))
        self.calls = 0

    def step(self, deadline: float | None = None) -> Call:
        c = self.calls % len(self.batches)
        self.calls += 1
        batch = self.batches[c]
        call = Call(c, len(batch.items), time.perf_counter(), 0.0)
        try:
            verify_chains_batched([batch], self.plane)
        except ValueError as e:
            call.error = verdict(e)
        call.t1 = time.perf_counter()
        call.spans.append(("chain.call", call.t0, call.t1))
        return call

    def warm(self) -> None:
        """One round over every chain: builds each set's tables (K2)."""
        for _ in self.batches:
            self.step()
        self.calls = 0

    def close(self) -> None:
        self.plane.stop()

    @staticmethod
    def end_to_end(calls: list, window_s: float) -> dict:
        return {E2E: sum(c.pairs for c in calls) / window_s}

    @staticmethod
    def host_spans(calls: list) -> list:
        return [s for c in calls for s in c.spans]

    def judge(self, calls: list, rng) -> tuple:
        return judge.judge_relay(
            self.t, [{"chain": c.chain, "error": c.error} for c in calls],
            rng)
