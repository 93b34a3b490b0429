"""Mempool ingress overload scenarios: the 100k tx/s flood gate and
the priority-eviction audit.

ROADMAP item 3's acceptance bar, pointed at the admission controller
in `mempool/mempool.py`:

- `mempool-flood` (stress, rig tier): a seeded `scenarios/loadgen.py`
  flood drives >=100k txs/s of mixed valid / bad-sig / duplicate /
  low-priority traffic through the RPC `broadcast_tx_sync` handler
  into a live 4-validator WireMesh node, with admission p50/p99
  latency and the rig's `commit_latency_p99` declared as metric
  budgets — consensus must keep committing WHILE the front door sheds
  an order of magnitude more traffic than the pool can hold.
- `eviction-storm` (smoke, tier-1 adjacent): a capped standalone pool
  under a mixed-priority storm must evict lowest-priority-oldest
  first with ZERO priority inversions, account every submission in
  exactly one outcome (zero silent drops — every rejection lands in
  `mempool_rejected{reason}`, every eviction in `mempool_evicted`),
  drop evicted hashes from the dedup cache so resubmission works, and
  journal evictions so a crash + `recover_wal` resurrects exactly the
  surviving set.

Both scenarios observe admission latency through bucket DELTAS of the
`mempool_admit_seconds` histogram, so a nightly process that ran other
scenarios first cannot pollute the quantiles.

Copy of `tendermint_tpu/scenarios/mempool_scenarios.py` with the port's
explicit wiring: the flood's mesh runs on `ctx.backend` (one plane for
its four nodes), and the storm's pools verify on a `BatchPlane` over
`ctx.backend` that the body builds and stops (the JAX pools use the
process-wide plane), so on the card every signed fill and storm tx
verifies on kernel K5 through `check_tx`.  The flood's few signed
envelopes are signed on the host (`loadgen.build_corpus` with no
backend), as the JAX corpus is.
"""

from __future__ import annotations

import os
import tempfile
import types

from tendermint_tpu_torch.batchplane import BatchPlane
from tendermint_tpu_torch.config import MempoolConfig, test_config
from tendermint_tpu_torch.mempool.mempool import Mempool, sign_tx_ed25519
from tendermint_tpu_torch.proxy import ClientCreator
from tendermint_tpu_torch.rpc.routes import Routes
from tendermint_tpu_torch.scenarios import harness, loadgen
from tendermint_tpu_torch.scenarios import invariants as inv
from tendermint_tpu_torch.scenarios.engine import register
from tendermint_tpu_torch.utils.metrics import REGISTRY

# commit work per height is bounded so the 1-vCPU rig spends its GIL
# slices on admission + consensus instead of giant DeliverTx sweeps
# (a commit is 4 in-process nodes each verifying + delivering the
# block, so every 128 block-txs costs the flood workers real GIL time)
FLOOD_BLOCK_TXS = 96
FLOOD_TIMEOUTS = {
    "timeout_propose": 3.0, "timeout_propose_delta": 1.0,
    "timeout_prevote": 1.5, "timeout_prevote_delta": 0.5,
    "timeout_precommit": 1.5, "timeout_precommit_delta": 0.5,
    # a 3s inter-height rest (test_config skips it by default): the rig
    # stays live under flood without the GIL spending most of its
    # slices on back-to-back commits
    "timeout_commit": 3.0, "skip_timeout_commit": 0,
}


def _rpc_for(mempool) -> Routes:
    """A Routes table over a stub node: the scenarios exercise the real
    RPC broadcast handlers (parse, check_tx, result shaping) without
    paying for a full Node."""
    node = types.SimpleNamespace(config=test_config(), mempool=mempool,
                                 switch=None)
    return Routes(node)


def _admit_buckets():
    return REGISTRY.mempool_admit_seconds.buckets()


def _delta_quantile(before, after, q: float) -> float:
    """q-quantile of the admissions observed BETWEEN two cumulative
    bucket snapshots (same interpolation as Histogram.quantile)."""
    total = after[-1][1] - before[-1][1]
    if total <= 0:
        return 0.0
    target = q * total
    lo, prev = 0.0, 0
    top = after[-2][0] if len(after) > 1 else after[-1][0]
    for (le, c1), (_, c0) in zip(after, before):
        cum = c1 - c0
        if cum >= target and cum > prev:
            if le == float("inf"):
                return top
            return lo + (le - lo) * (target - prev) / (cum - prev)
        if le != float("inf"):
            lo = le
        prev = cum
    return top


def _rejected_total() -> int:
    return sum(v for _, v in REGISTRY.mempool_rejected.items())


def _evicted_total() -> int:
    return sum(v for _, v in REGISTRY.mempool_evicted.items())


# -- mempool-flood ---------------------------------------------------------

def _flood_body(ctx):
    rng = ctx.rng("flood")
    mesh = harness.WireMesh("chaos-mempool-flood", 4, seed=7,
                            timeouts=FLOOD_TIMEOUTS, backend=ctx.backend)
    for nd in mesh.nodes:
        nd.cs.cfg.max_block_size_txs = FLOOD_BLOCK_TXS
    target = mesh.nodes[0].mempool
    # overload knobs: a pool two orders of magnitude smaller than the
    # offered traffic, and a backpressure trigger of ONE pending verify
    # lane — on a 1-vCPU rig a single in-flight mempool-class verify IS
    # plane saturation, and shedding signature floods before the verify
    # (not after) is exactly what keeps the front door at 100k+/s while
    # each verify costs tens of ms
    target.max_txs = 1_000
    target.max_bytes = 2_000_000
    target.backpressure_lanes = 1
    call = _rpc_for(target).broadcast_tx_sync
    # bulk traffic is unsigned priority-0 (the O(1) full-shed path);
    # signed/bad-sig lanes are present but RARE: every pure-python
    # verify the plane accepts holds the GIL ~10ms, so a dense signed
    # slice keeps one verify perpetually in flight and taxes the cheap
    # shed paths ~50%.  A sparse slice (bad-sig entries still re-verify
    # every cycle — rejection pops them from the dedup cache) exercises
    # verify/evict/backpressure while leaving the plane mostly idle
    corpus = loadgen.build_corpus(
        rng, loadgen.Mix(unsigned=30_000, signed=4, bad_sig=2,
                         dup_frac=0.15), backend=None)
    ctx.plan("flood.rig", validators=4, corpus=len(corpus),
             max_txs=target.max_txs,
             backpressure_lanes=target.backpressure_lanes)

    rejected0, evicted0 = _rejected_total(), _evicted_total()
    mesh.start()
    mesh.start_sampler()
    try:
        base_ok = harness.wait_until(lambda: mesh.quorum_height() >= 2,
                                     timeout=120)
        h0 = mesh.quorum_height()
        # launch the flood on the heels of a fresh commit so its window
        # opens in the inter-height gap rather than mid-commit
        harness.wait_until(lambda: mesh.quorum_height() > h0, timeout=60)
        h0 = mesh.quorum_height()
        ctx.snapshot_metrics("preflood")
        b0 = _admit_buckets()
        # 3 workers: the GIL serializes the cheap reject paths anyway
        # (more pumping threads only thrash), but the plane keeps ~one
        # signed verify in flight at all times, pinning ~one worker —
        # two spares keep the shed paths saturated through those stalls
        # 6s spans two full commit cadences, so offered/s averages over
        # the commit GIL bursts instead of riding one good/bad alignment.
        # 2 workers: the GIL serializes the shed path, so extra pumping
        # threads only add switch thrash — the second worker exists to
        # keep pumping through the (rare) verify stalls of the first
        report = loadgen.LoadGen(call, corpus, workers=2).run(
            duration_s=6.0)
        b1 = _admit_buckets()
        ctx.snapshot_metrics("postflood")
        # the rig must still be making progress: two more quorum
        # heights on top of wherever the flood found it
        alive = harness.wait_until(
            lambda: mesh.quorum_height() >= h0 + 2, timeout=120)
        h1 = mesh.quorum_height()
    finally:
        mesh.stop()
    p50 = _delta_quantile(b0, b1, 0.50)
    p99 = _delta_quantile(b0, b1, 0.99)
    commit_p99 = mesh.commit_latency_p99()
    rejected_d = _rejected_total() - rejected0
    evicted_d = _evicted_total() - evicted0
    budget_metrics = {
        "offered_per_sec": round(report.offered_per_sec, 1),
        "admit_p50_s": round(p50, 6),
        "admit_p99_s": round(p99, 6),
        "backpressure_rejections": report.outcomes["backpressure"],
    }
    if commit_p99 is not None:
        budget_metrics["commit_latency_p99"] = round(commit_p99, 3)
    ctx.note("flood.result", heights=(h0, h1), evicted=evicted_d,
             rejected=rejected_d, offered=report.offered,
             duration_s=round(report.duration_s, 3),
             outcomes=dict(report.outcomes), **budget_metrics)
    return {"base_ok": base_ok, "alive": alive, "h0": h0, "h1": h1,
            "offered": report.offered, "outcomes": report.outcomes,
            "rejected_delta": rejected_d, "evicted_delta": evicted_d,
            "budget_metrics": budget_metrics}


def _flood_safety_accounting(ctx, obs):
    out = obs["outcomes"]
    inv.require(out["error"] == 0,
                f"{out['error']} submissions raised instead of "
                f"returning a typed outcome")
    inv.require(sum(out.values()) == obs["offered"],
                "loadgen outcome buckets do not sum to offered load")
    # every non-admitted submission must land in mempool_rejected:
    # admitted txs may additionally be evicted later, but a rejection
    # that the counters never saw is a silent drop
    not_admitted = obs["offered"] - out["admitted"]
    inv.require(obs["rejected_delta"] == not_admitted,
                f"mempool_rejected moved {obs['rejected_delta']} for "
                f"{not_admitted} non-admitted submissions — "
                f"silent drops")


def _flood_safety_overload_modes(ctx, obs):
    out = obs["outcomes"]
    inv.require(out["full"] > 0,
                "the flood never hit the full-pool rejection path — "
                "not an overload run")
    inv.require(out["bad_sig"] > 0,
                "no bad-signature rejections: the verify gate went "
                "unexercised")
    inv.require(out["dup"] > 0,
                "no duplicate rejections: the dedup cache went "
                "unexercised")
    inv.require(obs["evicted_delta"] > 0,
                "no priority evictions: the flood never displaced a "
                "lower-priority tx")


def _flood_liveness_rig(ctx, obs):
    inv.completed(obs, "base_ok", "initial convergence of the mesh")
    inv.completed(obs, "alive",
                  f"quorum progress under flood (reached {obs['h1']}, "
                  f"needed {obs['h0'] + 2})")


def _flood_liveness_offered(ctx, obs):
    inv.require(obs["offered"] > 0, "loadgen offered no traffic")


register(
    "mempool-flood",
    "a seeded loadgen drives >=100k tx/s of mixed valid/bad-sig/dup/"
    "low-priority traffic through the RPC broadcast path into one "
    "node of a live 4-validator WireMesh: admission sheds the "
    "overload through typed ERR_MEMPOOL_FULL rejections, priority "
    "eviction and reject-before-verify backpressure, within admission "
    "p50/p99 latency budgets, while the rig keeps committing inside "
    "its commit_latency_p99 budget",
    safety=[("zero-silent-drops", _flood_safety_accounting),
            ("all-overload-modes-exercised", _flood_safety_overload_modes)],
    liveness=[("rig-commits-through-flood", _flood_liveness_rig),
              ("flood-ran", _flood_liveness_offered)],
    smoke=False, budget_s=420.0, backend="rig",
    budgets={"offered_per_sec": {"min": 100_000},
             "admit_p50_s": {"max": 0.001},
             "admit_p99_s": {"max": 0.25},
             "backpressure_rejections": {"min": 1},
             "commit_latency_p99": {"max": 30.0}})(_flood_body)


# -- eviction-storm --------------------------------------------------------

STORM_POOL = 64          # pool cap: small enough to storm in seconds
STORM_FILL_PRIOS = (1, 2, 3, 4, 5)
STORM_PRIOS = (0, 1, 2, 3, 4, 5, 6, 7, 8, 9)


def _storm_body(ctx):
    rng = ctx.rng("storm")
    wal_dir = tempfile.mkdtemp(prefix="eviction-storm-")
    wal_path = os.path.join(wal_dir, "mempool.wal")
    cfg = MempoolConfig(max_txs=STORM_POOL, backpressure_lanes=0)
    conns = ClientCreator("kvstore").new_app_conns()
    plane = BatchPlane(ctx.backend)
    try:
        return _storm(ctx, rng, wal_path, cfg, conns, plane)
    finally:
        plane.stop()


def _storm(ctx, rng, wal_path, cfg, conns, plane):
    mp = Mempool(conns.mempool, cfg, wal_path=wal_path, plane=plane)
    call = _rpc_for(mp).broadcast_tx_sync

    evict_log: list = []     # (victim tx, victim prio, survivor floor)
    inversions = [0]

    def on_evict(h, tx, prio):
        # fired under the pool lock: _tx_prio is exactly the survivor
        # set (victims of a multi-eviction still pending count as
        # survivors — if one of THEM ranks below this victim, that is
        # a real inversion too)
        floor = min(mp._tx_prio.values(), default=None)
        evict_log.append((tx, prio, floor))
        if floor is not None and prio > floor:
            inversions[0] += 1

    mp.on_evict = on_evict
    rejected0, evicted0 = _rejected_total(), _evicted_total()
    b0 = _admit_buckets()
    outcomes = dict.fromkeys(loadgen.OUTCOMES, 0)

    def submit(tx: bytes) -> str:
        k = loadgen.classify(call, {"tx": tx.hex()})
        outcomes[k] += 1
        return k

    # -- phase 1: fill the pool to its cap with mid-priority txs ------
    fill = [sign_tx_ed25519(rng.randbytes(32), b"fill-%03d" % i,
                            priority=rng.choice(STORM_FILL_PRIOS))
            for i in range(STORM_POOL)]
    for tx in fill:
        submit(tx)
    filled = mp.size()
    ctx.plan("storm.filled", size=filled, cap=STORM_POOL)

    # -- phase 2: the storm — mixed priorities against a full pool ----
    storm = [sign_tx_ed25519(rng.randbytes(32), b"storm-%03d" % i,
                             priority=rng.choice(STORM_PRIOS))
             for i in range(160)]
    for tx in storm:
        submit(tx)
    evicted_txs = [tx for tx, _, _ in evict_log]
    ctx.note("storm.stormed", evictions=len(evict_log),
             size=mp.size(), inversions=inversions[0])

    # -- phase 3: crash + recover — the journal must hold exactly the
    # surviving set, never an evicted tx (no close(): a crash doesn't
    # flush politely) --------------------------------------------------
    survivors = {h for h, _, _ in mp.txs_with_heights()}
    conns2 = ClientCreator("kvstore").new_app_conns()
    mp2 = Mempool(conns2.mempool, cfg, wal_path=wal_path, plane=plane)
    recovered_n = mp2.recover_wal()
    recovered = {h for h, _, _ in mp2.txs_with_heights()}
    mp2.close()
    recovery_exact = recovered == survivors

    # -- phase 4: commit everything, then resubmit evicted txs — their
    # hashes must have left the dedup cache (admitted now), while a
    # COMMITTED tx must stay permanently deduped -----------------------
    committed = mp.reap(-1)
    mp.update(1, committed)
    resample = ctx.rng("resubmit").sample(
        evicted_txs, min(len(evicted_txs), 12))
    resubmit_outcomes = [submit(tx) for tx in resample]
    committed_resubmit = (submit(committed[0]) if committed
                          else "admitted")
    b1 = _admit_buckets()
    rejected_d = _rejected_total() - rejected0
    evicted_d = _evicted_total() - evicted0
    mp.close()
    offered = sum(outcomes.values())
    admitted = outcomes["admitted"]
    unaccounted = (offered - admitted) - rejected_d
    budget_metrics = {
        "priority_inversions": inversions[0],
        "unaccounted_rejections": unaccounted,
        "evictions": evicted_d,
        "admit_p99_s": round(_delta_quantile(b0, b1, 0.99), 6),
    }
    ctx.note("storm.result", offered=offered, outcomes=dict(outcomes),
             survivors=len(survivors), recovered=recovered_n,
             resubmitted=len(resample), **budget_metrics)
    return {"offered": offered, "outcomes": outcomes,
            "filled": filled, "evict_log_len": len(evict_log),
            "rejected_delta": rejected_d, "evicted_delta": evicted_d,
            "recovery_exact": recovery_exact,
            "recovered_count": recovered_n,
            "survivor_count": len(survivors),
            "resubmit_outcomes": resubmit_outcomes,
            "committed_resubmit": committed_resubmit,
            "budget_metrics": budget_metrics}


def _storm_safety_no_inversion(ctx, obs):
    inv.require(obs["budget_metrics"]["priority_inversions"] == 0,
                f"{obs['budget_metrics']['priority_inversions']} "
                f"higher-priority txs were evicted while a "
                f"lower-priority tx survived")


def _storm_safety_accounting(ctx, obs):
    out = obs["outcomes"]
    inv.require(out["error"] == 0,
                f"{out['error']} submissions raised instead of "
                f"returning a typed outcome")
    inv.require(obs["budget_metrics"]["unaccounted_rejections"] == 0,
                f"{obs['budget_metrics']['unaccounted_rejections']} "
                f"rejections missing from mempool_rejected{{reason}} "
                f"— silent drops")
    inv.require(obs["evicted_delta"] == obs["evict_log_len"],
                "mempool_evicted disagrees with the eviction hook — "
                "an eviction went uncounted")


def _storm_safety_resubmission(ctx, obs):
    inv.require(obs["resubmit_outcomes"] and
                all(k != "dup" for k in obs["resubmit_outcomes"]),
                f"an evicted tx was still dedup-cached on resubmit: "
                f"{obs['resubmit_outcomes']}")
    inv.require(all(k == "admitted" for k in obs["resubmit_outcomes"]),
                f"evicted txs failed to re-enter an emptied pool: "
                f"{obs['resubmit_outcomes']}")
    inv.require(obs["committed_resubmit"] == "dup",
                f"a COMMITTED tx re-entered as "
                f"'{obs['committed_resubmit']}' — committed txs must "
                f"stay permanently deduped")


def _storm_safety_recovery(ctx, obs):
    inv.require(obs["recovery_exact"],
                f"recover_wal resurrected a set of "
                f"{obs['recovered_count']} txs != the "
                f"{obs['survivor_count']} storm survivors — an "
                f"evicted tx came back (or a survivor was lost)")


def _storm_liveness(ctx, obs):
    inv.require(obs["filled"] == STORM_POOL,
                f"pool never reached its cap ({obs['filled']}/"
                f"{STORM_POOL}) — the storm tested nothing")
    inv.require(obs["evicted_delta"] >= 10,
                f"only {obs['evicted_delta']} evictions — the storm "
                f"never stormed")
    inv.require(obs["outcomes"]["full"] >= 10,
                f"only {obs['outcomes']['full']} full rejections — "
                f"low-priority shedding went unexercised")


register(
    "eviction-storm",
    "a capped pool under a mixed-priority storm: evictions are "
    "lowest-priority-oldest with zero priority inversions, every "
    "submission lands in exactly one counted outcome (zero silent "
    "drops), evicted hashes leave the dedup cache so resubmission "
    "works, committed txs stay deduped, and a crash + recover_wal "
    "resurrects exactly the surviving set",
    safety=[("no-priority-inversion", _storm_safety_no_inversion),
            ("zero-silent-drops", _storm_safety_accounting),
            ("evicted-resubmits-committed-does-not",
             _storm_safety_resubmission),
            ("wal-recovers-survivors-only", _storm_safety_recovery)],
    liveness=[("storm-reached-overload", _storm_liveness)],
    smoke=True, budget_s=180.0,
    budgets={"priority_inversions": {"max": 0},
             "unaccounted_rejections": {"max": 0},
             "evictions": {"min": 10},
             "admit_p99_s": {"max": 0.5}})(_storm_body)
