"""Batch-plane isolation scenarios: concurrent workloads sharing the
one verify scheduler must coalesce, not collide.

ROADMAP item 2's acceptance bar: replay (fast-sync commit verifies)
and a light-client query stream running concurrently through
`batchplane/scheduler.py` each keep >=70% of the throughput they get
with the device to themselves, and the batch-occupancy evidence shows
WHY — their lanes ride the same flushed chunks, so sharing the chip
costs amortized padding instead of serialized half-full batches.  This
is the Blockchain Machine claim (arXiv:2104.06968) made falsifiable:
one batch crypto pipeline multiplexing all protocol traffic beats one
pipeline per producer.

The producers are PACED (submit, wait, think), not device-saturating
closed loops, because the retention bar is about scheduling, not raw
capacity.  On the CPU backend a verify flush costs ~linearly per lane
(measured on the tier-1 rig: bucket 16 ~0.21s, 32 ~0.39s, 64 ~0.76s
warm), so two producers saturating one core can each keep at most
~f16/f32 = 55% no matter how the scheduler slices — while on a TPU
the same doubling is overhead-dominated and nearly free.  Paced below
saturation, the deadline window phase-locks the two producers into
shared flushes (both unblock on the same flush, think the same time,
resubmit inside the same 20 ms deadline), which is exactly the mixed-
batch amortization the plane exists to provide.

The lane counts are COMPLEMENTARY on purpose: replay submits 11
lanes, light 5, so alone each pads a half-full power-of-2 chunk
(11/16, 5/8) while merged they fill bucket 16 exactly — the shared
flush rides the SAME pre-warmed executable replay uses alone, which
is why the concurrent occupancy mean must beat the single-producer
baseline and why coalescing is nearly free.

Two tiers, one body:

- `batchplane-isolation` (smoke, tier-1): CPU-scaled — 11+5 lane
  calls on chunk shapes the suite already compiles, ~25 s of wall
  clock.
- `batchplane-flood-isolation` (stress, faults+slow): 8x the lanes per
  call with the retention bar declared as a metric budget, so every
  nightly seed lands a retention number in `CHAOS_LEDGER.jsonl` and a
  slow isolation regression trips the chaos gate rather than hiding
  behind a green invariant.

Both producers submit grouped verifies against the SAME validator set
(one comb table, one merge key) — the configuration the plane exists
for; disjoint sets cannot share a chunk and degrade to time-slicing.

Copy of `tendermint_tpu/scenarios/batchplane_scenarios.py` with the
port's explicit wiring: each run builds one `BatchPlane` over
`ctx.backend`, hands it to its producers, drains it where the JAX body
drains the process-wide plane and stops it at the end (the JAX body
resets the process-wide plane instead).  On the card every flush is one
grouped verify, kernel K1 against comb tables built once by K2.  The
plane counters these bodies read are process-wide, so they read deltas
between metric snapshots only, as the JAX bodies do.
"""

from __future__ import annotations

import threading
import time

import numpy as np

from tendermint_tpu_torch.batchplane import (CLASS_FASTSYNC, CLASS_LIGHT,
                                             BatchPlane)
from tendermint_tpu_torch.crypto import pure_ed25519 as ref
from tendermint_tpu_torch.scenarios import invariants as inv
from tendermint_tpu_torch.scenarios.engine import register

MSG_LEN = 96          # the vote sign-bytes length every warm shape uses
V = 4                 # validator-set size (one comb table build)


def _signed_lanes(rng, lanes: int):
    """`lanes` real ed25519 lanes over a V-validator set, signed once
    from seed-derived keys; drives resubmit the same arrays (the device
    cannot tell a repeated signature from a fresh one)."""
    seeds = [rng.randbytes(32) for _ in range(V)]
    pubs = [ref.pubkey_from_seed(s) for s in seeds]
    vp = np.frombuffer(b"".join(pubs), np.uint8).reshape(V, 32)
    idx = (np.arange(lanes) % V).astype(np.int64)
    msgs = [rng.randbytes(MSG_LEN) for _ in range(lanes)]
    sigs = [ref.sign(seeds[idx[i]], msgs[i]) for i in range(lanes)]
    ma = np.frombuffer(b"".join(msgs), np.uint8).reshape(lanes, MSG_LEN)
    sa = np.frombuffer(b"".join(sigs), np.uint8).reshape(lanes, 64)
    return vp, idx, ma, sa


class _Producer:
    """Paced driver: N rounds of submit -> wait -> think.  Throughput
    is lanes over the time from first submission to last result; with
    a fixed round count the retention ratio reduces to iso_elapsed /
    conc_elapsed, immune to end-of-phase quantization."""

    def __init__(self, plane, name, klass, set_key, vp, idx, msgs, sigs,
                 rounds: int, think_s: float,
                 barrier: threading.Barrier | None = None):
        self.plane = plane
        self.name, self.klass = name, klass
        self.args = (set_key, vp, idx, msgs, sigs)
        self.rounds = rounds
        self.think_s = think_s
        self.barrier = barrier
        self.lanes_per_call = len(idx)
        self.elapsed = 0.0
        self.bad_lanes = 0
        self.error: BaseException | None = None

    def run(self) -> None:
        plane = self.plane
        try:
            if self.barrier is not None:
                self.barrier.wait(timeout=30.0)
            t0 = time.perf_counter()
            for i in range(self.rounds):
                ok = plane.submit_grouped(
                    *self.args, producer=self.name,
                    klass=self.klass).wait()
                self.bad_lanes += int((~ok).sum())
                self.elapsed = time.perf_counter() - t0
                if i + 1 < self.rounds:
                    time.sleep(self.think_s)
        except BaseException as e:          # surfaced as an invariant
            self.error = e

    @property
    def lanes_per_sec(self) -> float:
        return (self.rounds * self.lanes_per_call
                / max(self.elapsed, 1e-9))


def _plane_deltas(ctx, start: str, end: str) -> dict:
    """Batch-plane counter movement between two metric snapshots."""
    a = ctx.metrics(start) or {}
    b = ctx.metrics(end) or {}

    def d(key):
        return (b.get(key) or 0) - (a.get(key) or 0)

    occ_a = a.get("batchplane_occupancy") or {}
    occ_b = b.get("batchplane_occupancy") or {}
    n = (occ_b.get("count", 0) or 0) - (occ_a.get("count", 0) or 0)
    s = (occ_b.get("sum", 0.0) or 0.0) - (occ_a.get("sum", 0.0) or 0.0)
    return {"flushes": d("batchplane_flushes"),
            "mixed": d("batchplane_mixed_batches"),
            "occupancy_mean": (s / n) if n else 0.0}


def _run_pair(producers: list) -> None:
    ths = [threading.Thread(target=p.run, daemon=True)
           for p in producers]
    for t in ths:
        t.start()
    for t in ths:
        t.join()
    for p in producers:
        if p.error is not None:
            raise p.error


def _isolation(ctx, fastsync_lanes: int, light_lanes: int,
               rounds: int, think_s: float):
    rng = ctx.rng("lanes")
    set_key = b"batchplane-isolation"
    total = fastsync_lanes + light_lanes
    vp, idx, ma, sa = _signed_lanes(rng, total)
    per_producer = {
        "fastsync": (idx[:fastsync_lanes], ma[:fastsync_lanes],
                     sa[:fastsync_lanes]),
        "light": (idx[fastsync_lanes:], ma[fastsync_lanes:],
                  sa[fastsync_lanes:]),
    }
    ctx.plan("isolation.rig", fastsync_lanes=fastsync_lanes,
             light_lanes=light_lanes, rounds=rounds, think_s=think_s,
             validators=V)

    plane = BatchPlane(ctx.backend)

    def producer(name, klass, barrier=None, rounds_=None):
        pidx, pma, psa = per_producer[name]
        return _Producer(plane, name, klass, set_key, vp, pidx, pma, psa,
                         rounds_ or rounds, think_s, barrier=barrier)

    try:
        # warm the table build + both chunk shapes OUTSIDE the timed
        # phases: one solo round (iso bucket) and one barrier-aligned
        # pair (the doubled concurrent bucket) — on a cold XLA cache
        # this is where the compiles land
        for name, klass in (("fastsync", CLASS_FASTSYNC),
                            ("light", CLASS_LIGHT)):
            w = producer(name, klass, rounds_=1)
            w.run()
            if w.error is not None:
                raise w.error
        bar = threading.Barrier(2)
        _run_pair([producer("fastsync", CLASS_FASTSYNC,
                            barrier=bar, rounds_=1),
                   producer("light", CLASS_LIGHT,
                            barrier=bar, rounds_=1)])

        # -- isolated baselines: each producer alone ------------------
        ctx.snapshot_metrics("iso-start")
        iso = {}
        for name, klass in (("fastsync", CLASS_FASTSYNC),
                            ("light", CLASS_LIGHT)):
            p = producer(name, klass)
            p.run()
            if p.error is not None:
                raise p.error
            iso[name] = p
        plane.drain()
        ctx.snapshot_metrics("conc-start")

        # -- concurrent: barrier-started so round 1 already coalesces;
        # after that the shared flush keeps them phase-locked ----------
        bar = threading.Barrier(2)
        conc = {"fastsync": producer("fastsync",
                                     CLASS_FASTSYNC,
                                     barrier=bar),
                "light": producer("light", CLASS_LIGHT,
                                  barrier=bar)}
        _run_pair(list(conc.values()))
        plane.drain()
        ctx.snapshot_metrics("end")
    finally:
        plane.stop()

    iso_d = _plane_deltas(ctx, "iso-start", "conc-start")
    conc_d = _plane_deltas(ctx, "conc-start", "end")
    retention = {n: (conc[n].lanes_per_sec / iso[n].lanes_per_sec
                     if iso[n].lanes_per_sec > 0 else 0.0)
                 for n in iso}
    ctx.note("isolation.result",
             iso_lps={n: round(p.lanes_per_sec, 1)
                      for n, p in iso.items()},
             conc_lps={n: round(p.lanes_per_sec, 1)
                       for n, p in conc.items()},
             retention={n: round(r, 3) for n, r in retention.items()},
             iso_occupancy=round(iso_d["occupancy_mean"], 3),
             conc_occupancy=round(conc_d["occupancy_mean"], 3),
             mixed_flushes=conc_d["mixed"], flushes=conc_d["flushes"])
    return {"iso_elapsed": {n: round(p.elapsed, 3)
                            for n, p in iso.items()},
            "conc_elapsed": {n: round(p.elapsed, 3)
                             for n, p in conc.items()},
            "bad_lanes": sum(p.bad_lanes for p in
                             list(iso.values()) + list(conc.values())),
            "retention_fastsync": retention["fastsync"],
            "retention_light": retention["light"],
            "iso_occupancy_mean": iso_d["occupancy_mean"],
            "conc_occupancy_mean": conc_d["occupancy_mean"],
            "conc_flushes": conc_d["flushes"],
            "conc_mixed_flushes": conc_d["mixed"],
            "budget_metrics": {
                "retention_fastsync": round(retention["fastsync"], 3),
                "retention_light": round(retention["light"], 3),
                "conc_occupancy_mean":
                    round(conc_d["occupancy_mean"], 3),
                "mixed_flush_frac": round(
                    conc_d["mixed"] / max(conc_d["flushes"], 1), 3)}}


def _safety_retention(ctx, obs):
    inv.require(obs["retention_fastsync"] >= 0.7,
                f"replay kept only "
                f"{obs['retention_fastsync']:.0%} of its isolated "
                f"throughput under a concurrent light stream "
                f"(bar: 70%)")
    inv.require(obs["retention_light"] >= 0.7,
                f"light stream kept only "
                f"{obs['retention_light']:.0%} of its isolated "
                f"throughput while replay ran (bar: 70%)")


def _safety_coalescing(ctx, obs):
    # the MECHANISM behind the retention: concurrent lanes share
    # flushed chunks instead of padding separate half-full batches
    inv.require(obs["conc_mixed_flushes"] >= 1,
                "no flush carried lanes from both producers — the "
                "plane time-sliced instead of coalescing")
    inv.require(obs["conc_occupancy_mean"]
                > obs["iso_occupancy_mean"],
                f"concurrent occupancy "
                f"{obs['conc_occupancy_mean']:.2f} did not beat the "
                f"single-producer baseline "
                f"{obs['iso_occupancy_mean']:.2f}")


def _safety_correctness(ctx, obs):
    inv.require(obs["bad_lanes"] == 0,
                f"{obs['bad_lanes']} valid signatures verified False "
                f"under the shared plane")


def _liveness_both_finish(ctx, obs):
    for n in ("fastsync", "light"):
        inv.require(obs["conc_elapsed"][n] > 0,
                    f"{n} never completed its rounds under "
                    f"contention — starved")


_SAFETY = [("retention-70pct", _safety_retention),
           ("mixed-batches-prove-coalescing", _safety_coalescing),
           ("no-wrong-answers", _safety_correctness)]
_LIVENESS = [("both-producers-finish", _liveness_both_finish)]


def _isolation_smoke(ctx):
    # CPU-scaled: 11+5 lanes (buckets 16 and 8 alone, exactly 16
    # merged — the suite's warmest grouped shape), ~25s measured
    return _isolation(ctx, fastsync_lanes=11, light_lanes=5,
                      rounds=6, think_s=1.0)


def _isolation_flood(ctx):
    # 8x the lanes per call (88+40 -> bucket 128 merged); think time
    # scaled so the paced load still fits the CPU rig's capacity (see
    # module docstring)
    return _isolation(ctx, fastsync_lanes=88, light_lanes=40,
                      rounds=6, think_s=4.0)


register(
    "batchplane-isolation",
    "replay and a light-client stream share the unified batch plane: "
    "run each alone, then both concurrently — each must keep >=70% of "
    "its isolated lanes/sec, with mixed-producer flushes and a "
    "concurrent occupancy mean above the single-producer baseline "
    "proving the lanes coalesced (11+5 complementary lanes fill "
    "bucket 16 exactly) instead of time-slicing (CPU-scaled tier-1 "
    "twin of batchplane-flood-isolation)",
    safety=_SAFETY, liveness=_LIVENESS,
    smoke=True, budget_s=240.0)(_isolation_smoke)


register(
    "batchplane-flood-isolation",
    "the batchplane-isolation rig at flood scale (88+40 lane calls): "
    "per-producer throughput retention >=70% and the coalescing "
    "evidence are declared metric budgets, so every nightly seed "
    "ledgers a retention number and a slow isolation regression trips "
    "the chaos gate",
    safety=_SAFETY, liveness=_LIVENESS,
    smoke=False, budget_s=600.0,
    budgets={"retention_fastsync": {"min": 0.7},
             "retention_light": {"min": 0.7},
             "conc_occupancy_mean": {"min": 0.05},
             "mixed_flush_frac": {"min": 0.5}})(_isolation_flood)
