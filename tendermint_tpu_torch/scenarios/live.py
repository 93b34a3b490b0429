"""Live-consensus big rigs: 50-100 validators committing heights while
a combined adversary fires.

These are the scale tier of the scenario catalogue: a full WireMesh of
ConsensusStates (scenarios/harness.py) must keep committing while
partitions isolate a minority island, nodes crash and restart from
their own committed prefix, one validator equivocates, and the
scenario's supervised crypto ladder walks a demote/recover cycle.

Two properties of the wire rig shape every invariant here:

- No catchup gossip: a node that misses commits while severed or down
  stays permanently behind the quorum.  Liveness is therefore asserted
  for the QUORUM (the live, connected, current majority), and safety as
  committed-prefix agreement across every store — stale nodes may
  trail, but may never disagree.
- Adversary sizing keeps >2/3 of voting power live and connected at
  all times (partition + crash + byzantine counts are chosen so the
  remaining current voters clear the quorum threshold with margin).

Alongside the wall-clock budget, each rig declares METRIC budgets —
commit latency p99 (timestamped at the commit site by the lifecycle
hook, with the 50ms poll sampler as fallback), rounds-per-height
(round churn from stale proposers and partition waves), ladder
demotion count, and stage-level timeline budgets (prevote-quorum p99
and gossip fan-out p99 from the merged telemetry timeline) — checked
by the engine as first-class invariants and ledgered per-seed.

Copy of `tendermint_tpu/scenarios/live.py`.  The mesh runs on one plane
over `ctx.backend` (by default "cuda-rig": the rig ladder with a
`CudaBackend` as its "dev" rung), and the ladder walk sets the ladder's
`chaos` itself instead of installing a chaos config.  On the card the
vote bursts go to kernel K1 while the ladder's active rung is the
CUDA one, and to the scalar path while the walk holds it open.
"""

from __future__ import annotations

import threading
import time

import numpy as np

from tendermint_tpu_torch.scenarios import harness, injectors
from tendermint_tpu_torch.scenarios import invariants as inv
from tendermint_tpu_torch.scenarios.engine import register
from tendermint_tpu_torch.utils import chaos as chaosmod
from tendermint_tpu_torch.utils.metrics import REGISTRY

# a big net on memoized pure-python crypto commits a height in ~1.5s
# (n=50) / ~4s (n=100); propose windows must cover a full height of
# GIL-shared work plus scheduler jitter or every height burns rounds
LIVE_TIMEOUTS_50 = {
    "timeout_propose": 5.0, "timeout_propose_delta": 1.5,
    "timeout_prevote": 2.5, "timeout_prevote_delta": 0.75,
    "timeout_precommit": 2.5, "timeout_precommit_delta": 0.75,
}
LIVE_TIMEOUTS_100 = {
    "timeout_propose": 8.0, "timeout_propose_delta": 2.0,
    "timeout_prevote": 4.0, "timeout_prevote_delta": 1.0,
    "timeout_precommit": 4.0, "timeout_precommit_delta": 1.0,
}


def _walk_ladder(ctx) -> None:
    """Demote and recover the scenario's supervised ladder while the
    mesh keeps committing: set a raise-mode crypto chaos spec on it,
    probe `verify_batch` until the breaker trips, clear the storm, and
    probe until the half-open path recovers the rung.  Scalar vote
    verifies go through types/keys.py; micro-batching engages only while
    the active rung is a CudaBackend on the card, so on "cuda-rig" the
    walk moves the mesh's vote bursts from kernel K1 to the scalar path
    and back — the leg proves the ladder machinery stays live UNDER the
    rig load, and feeds the ladder_demotions budget metric."""
    be = ctx.backend
    if be is None or not hasattr(be, "_rungs"):
        ctx.note("live.rungwalk-skipped", reason="scalar backend")
        return
    from tendermint_tpu_torch.crypto import pure_ed25519 as ref
    trips0 = REGISTRY.crypto_breaker_trips.value
    recov0 = REGISTRY.crypto_breaker_recoveries.value
    be.chaos = chaosmod.ChaosConfig(seed=ctx.seed,
                                    crypto="raise:every=1").crypto
    seed32 = bytes(32)
    pub = np.frombuffer(ref.pubkey_from_seed(seed32), np.uint8)
    msg = np.zeros(32, np.uint8)
    sig = np.frombuffer(ref.sign(seed32, msg.tobytes()), np.uint8)
    deadline = time.time() + 20
    while (REGISTRY.crypto_breaker_trips.value == trips0
           and time.time() < deadline):
        be.verify_batch(pub[None, :], msg[None, :], sig[None, :])
        time.sleep(0.02)
    be.chaos.active = False
    ctx.note("live.chaos-cleared",
             tripped=REGISTRY.crypto_breaker_trips.value > trips0)
    deadline = time.time() + 15
    while (REGISTRY.crypto_breaker_recoveries.value == recov0
           and time.time() < deadline):
        be.verify_batch(pub[None, :], msg[None, :], sig[None, :])
        time.sleep(0.05)
    ctx.note("live.rungwalk-done",
             trips=REGISTRY.crypto_breaker_trips.value - trips0,
             recoveries=REGISTRY.crypto_breaker_recoveries.value - recov0)


def _live_rounds_body(ctx, *, n: int, net_seed: int, target_heights: int,
                      timeouts: dict, partition_count: int,
                      crash_count: int, equivocations: int,
                      window_s: float, target_timeout_s: float):
    chain_id = f"chaos-live-{n}"
    rng = ctx.rng("live-adversary")
    # disjoint adversary cast, seed-derived and hash-logged: a replay on
    # the same seed partitions the same nodes
    idxs = list(range(n))
    rng.shuffle(idxs)
    victims = sorted(idxs[:partition_count])
    crash_targets = sorted(idxs[partition_count:
                                partition_count + crash_count])
    byz_i = (idxs[partition_count + crash_count]
             if equivocations else None)
    ctx.plan("adversary-cast", victims=victims, crashes=crash_targets,
             byz=byz_i, window_s=window_s)

    mesh = harness.WireMesh(chain_id, n, seed=net_seed, timeouts=timeouts,
                            backend=ctx.backend)
    evidence: list = []
    ev_lock = threading.Lock()
    if byz_i is not None:
        heights = injectors.plan_heights(ctx, "equivocation", 2,
                                         target_heights, k=equivocations)
        injectors.equivocate(ctx, mesh.nodes[byz_i], mesh.privs[byz_i],
                             chain_id, heights)
        for i, nd in enumerate(mesh.nodes):
            if i != byz_i:
                nd.cs.evsw.subscribe(
                    "scenario", "EvidenceDoubleSign",
                    lambda e: (ev_lock.acquire(), evidence.append(e),
                               ev_lock.release()))
    rounds0 = REGISTRY.rounds_started.value
    trips0 = REGISTRY.crypto_breaker_trips.value
    mesh.start()
    mesh.start_sampler()
    try:
        base_ok = harness.wait_until(lambda: mesh.quorum_height() >= 2,
                                     timeout=120)
        ctx.snapshot_metrics("converged")

        def partition_leg():
            mesh.isolate(victims)
            ctx.note("live.partitioned", victims=victims)
            time.sleep(window_s)
            mesh.heal()
            ctx.note("live.healed")

        def crash_leg():
            # quick cycles: mark-dead -> stop -> rebuild over the
            # retained store (replaying the committed prefix through a
            # fresh app); a restart that misses a height goes stale,
            # which the sizing absorbs
            for i in crash_targets:
                mesh.crash(i)
                ctx.note("live.crashed", node=i)
                time.sleep(0.5)
                mesh.restart(i)
                ctx.note("live.restarted", node=i,
                         height=mesh.nodes[i].block_store.height)

        sched = ctx.schedule("live-adversary")
        sched.add("partition", partition_leg, after=0.5, jitter_s=1.0)
        if crash_targets:
            sched.add("crash-restart", crash_leg, after=1.5, jitter_s=1.0)
        sched.add("rung-walk", lambda: _walk_ladder(ctx),
                  after=0.2, jitter_s=0.5)
        sched.run(join_timeout_s=120.0)

        reached = harness.wait_until(
            lambda: mesh.quorum_height() >= target_heights,
            timeout=target_timeout_s)
        quorum_h = mesh.quorum_height()
        total_height_gain = sum(s.height for s in mesh.stores())
        stores = mesh.stores()
    finally:
        mesh.stop()
    rounds_delta = REGISTRY.rounds_started.value - rounds0
    demotions = REGISTRY.crypto_breaker_trips.value - trips0
    p99 = mesh.commit_latency_p99()
    with ev_lock:
        ev_count = len(evidence)
    budget_metrics = {
        "rounds_per_height": round(
            rounds_delta / max(total_height_gain, 1), 3),
        "ladder_demotions": demotions,
    }
    # no samples means no observed commits: leave the metric out so the
    # budget check reports it missing instead of grading a placeholder
    if p99 is not None:
        budget_metrics["commit_latency_p99"] = round(p99, 3)
    # stage-level budgets from the mesh's merged timeline (telemetry/):
    # p99 duration of each quorum stage across every (node, height) and
    # the gossip fan-out p99 across every delivery.  Same omit-if-empty
    # rule as commit_latency_p99 — the engine grades MISSING as a
    # breach, so a rig that never committed reads red, not green.
    from tendermint_tpu_torch import telemetry
    timeline = telemetry.collect_mesh(mesh)
    telemetry.feed_registry(timeline)
    stats = timeline["stage_stats"]
    if stats.get("prevote", {}).get("count"):
        budget_metrics["prevote_quorum_p99"] = round(
            stats["prevote"]["p99"], 3)
        budget_metrics["precommit_quorum_p99"] = round(
            stats["precommit"]["p99"], 3)
    gossip = timeline["gossip"]
    if gossip.get("count"):
        budget_metrics["gossip_fanout_p99"] = round(gossip["p99"], 4)
    doctor = telemetry.consensus_doctor(timeline)
    ctx.note("live.timeline", heights=len(timeline["heights"]),
             nodes=len(timeline["nodes"]),
             largest_thief=doctor["largest_thief"],
             sums_to_wall=doctor["sums_to_wall"],
             commit_spread_p99=round(telemetry.collector.percentile(
                 [h["commit_spread_s"] for h in timeline["heights"]],
                 0.99), 4))
    ctx.note("live.result", quorum_height=quorum_h,
             target=target_heights, rounds_delta=rounds_delta,
             total_height_gain=total_height_gain,
             evidence=ev_count, restarts=mesh.restarts,
             heights=[s.height for s in stores],
             **budget_metrics)
    return {"base_ok": base_ok, "reached": reached,
            "quorum_height": quorum_h, "target_heights": target_heights,
            "byz": byz_i is not None, "evidence_count": ev_count,
            "restarts": mesh.restarts,
            "budget_metrics": budget_metrics,
            "_stores": stores}


def _live_safety_agreement(ctx, obs):
    inv.prefix_agreement(obs["_stores"])


def _live_safety_evidence(ctx, obs):
    if obs["byz"]:
        inv.require(obs["evidence_count"] >= 1,
                    "the equivocating validator ran unobserved — no "
                    "DuplicateVoteEvidence captured by any honest node")


def _live_liveness(ctx, obs):
    inv.completed(obs, "base_ok", "initial convergence of the mesh")
    inv.completed(
        obs, "reached",
        f"quorum commit progress under the combined adversary "
        f"(reached {obs['quorum_height']}, "
        f"needed {obs['target_heights']})")


def _live_liveness_ladder(ctx, obs):
    inv.metric_increased(ctx, "crypto_breaker_trips")
    inv.metric_increased(ctx, "crypto_breaker_recoveries")


register(
    "live-rounds-50",
    "50-validator live wire mesh under a COMBINED adversary: an 8-node "
    "minority island partition, a crash-restart that replays its own "
    "committed prefix, one equivocating validator, and a supervised "
    "ladder demote/recover walk; the quorum commits 10+ heights with "
    "prefix agreement everywhere, within commit-latency and "
    "round-churn budgets",
    safety=[("prefix-agreement", _live_safety_agreement),
            ("equivocation-evidenced", _live_safety_evidence)],
    liveness=[("quorum-commits-heights", _live_liveness),
              ("ladder-walked", _live_liveness_ladder)],
    smoke=False, budget_s=420.0, backend="rig",
    budgets={"commit_latency_p99": {"max": 30.0},
             "rounds_per_height": {"max": 3.0},
             "ladder_demotions": {"max": 50},
             # stage-level budgets (telemetry/): a prevote stage is
             # bounded by the same round-churn ceiling as commit
             # latency; gossip fan-out is in-process queue handoff, so
             # seconds of lag means the sender loop starved under GIL
             "prevote_quorum_p99": {"max": 30.0},
             "gossip_fanout_p99": {"max": 5.0}})(
    lambda ctx: _live_rounds_body(
        ctx, n=50, net_seed=5, target_heights=10,
        timeouts=LIVE_TIMEOUTS_50, partition_count=8, crash_count=1,
        equivocations=2, window_s=8.0, target_timeout_s=240.0))


register(
    "live-rounds-100-chaos",
    "100-validator live wire mesh under the heaviest combined "
    "adversary: a 15-node island partition, two crash-restarts, an "
    "equivocating validator, and a ladder demote/recover walk; the "
    "quorum still commits 6+ heights with prefix agreement and metric "
    "budgets held",
    safety=[("prefix-agreement", _live_safety_agreement),
            ("equivocation-evidenced", _live_safety_evidence)],
    liveness=[("quorum-commits-heights", _live_liveness),
              ("ladder-walked", _live_liveness_ladder)],
    smoke=False, budget_s=600.0, backend="rig",
    budgets={"commit_latency_p99": {"max": 60.0},
             "rounds_per_height": {"max": 4.0},
             "ladder_demotions": {"max": 50},
             "prevote_quorum_p99": {"max": 60.0},
             "gossip_fanout_p99": {"max": 10.0}})(
    lambda ctx: _live_rounds_body(
        ctx, n=100, net_seed=5, target_heights=6,
        timeouts=LIVE_TIMEOUTS_100, partition_count=15, crash_count=2,
        equivocations=2, window_s=10.0, target_timeout_s=300.0))
