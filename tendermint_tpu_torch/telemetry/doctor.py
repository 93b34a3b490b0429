"""Consensus doctor: name the largest thief per height range.

Same contract as `bench.py --doctor` (utils/attribution.doctor_report)
but over the LIVE timeline: each height's wall clock is partitioned by
the four lifecycle stages (sums-to-wall by construction), and the
doctor aggregates contiguous height ranges, maps stages onto named
thieves, and points at the guilty node:

- `slow_proposer`        — propose stage (waiting for the proposal)
- `quorum_straggler`     — prevote + precommit stages (quorum forming)
- `commit_apply`         — commit stage (parts completion + ApplyBlock)
- `batchplane_queue_wait`— vote-verify wait inside the quorum stages;
                           a COMPETITOR like attribution's
                           half_full_batches: it steals from inside the
                           partition, it does not add to the sum
- `gossip_delay`         — per-receiver serialized fan-out wait
                           (mesh gossip stats), also a competitor

The partition residual is carried per range so a consumer can verify
the invariant instead of trusting it.

Copy of `tendermint_tpu/telemetry/doctor.py`.
"""

from __future__ import annotations

from tendermint_tpu_torch.telemetry.collector import STAGES

CONSENSUS_DOCTOR_SCHEMA = "tpu-bft-consensus-doctor/1"

# stage -> partition thief (competitors are added separately)
_STAGE_THIEF = {"propose": "slow_proposer",
                "prevote": "quorum_straggler",
                "precommit": "quorum_straggler",
                "commit": "commit_apply"}
_RESIDUAL_TOL = 1e-6


def _chunk(heights: list[dict], range_len: int) -> list[list[dict]]:
    out, cur = [], []
    for row in heights:
        if cur and (row["height"] - cur[0]["height"] >= range_len or
                    row["height"] != cur[-1]["height"] + 1):
            out.append(cur)
            cur = []
        cur.append(row)
    if cur:
        out.append(cur)
    return out


def consensus_doctor(timeline: dict, range_len: int = 10) -> dict:
    """Machine-readable report over a merged timeline
    (`collector.build_timeline`).  Ranges are contiguous height chunks
    of at most `range_len`; each names its largest thief and the
    straggler / slow-proposer nodes behind the quorum stages."""
    heights = list(timeline.get("heights", ()))
    gossip = timeline.get("gossip") or {}
    total_wall = sum(r["wall_s"] for r in heights) or 0.0
    gossip_total = float(gossip.get("per_receiver_wait_s", 0.0))
    ranges = []
    residual_max = 0.0
    for chunk in _chunk(heights, range_len):
        stages = {s: 0.0 for s in STAGES}
        verify_wait = 0.0
        wall = 0.0
        lag_by_node: dict[str, float] = {}
        propose_by_node: dict[str, float] = {}
        residual = 0.0
        for row in chunk:
            wall += row["wall_s"]
            verify_wait += row["verify_wait_s"]
            for s in STAGES:
                stages[s] += row["stages"][s]
            residual = max(residual, abs(
                sum(row["stages"].values()) - row["wall_s"]))
            for node, cell in row.get("nodes", {}).items():
                lag_by_node[node] = (lag_by_node.get(node, 0.0) +
                                     cell["t_commit"] - row["t_commit"])
                propose_by_node[node] = (propose_by_node.get(node, 0.0) +
                                         cell["stages"]["propose"])
        residual_max = max(residual_max, residual)
        thieves = {"slow_proposer": 0.0, "quorum_straggler": 0.0,
                   "commit_apply": 0.0}
        for s, v in stages.items():
            thieves[_STAGE_THIEF[s]] += v
        # competitors: steal from INSIDE the stages, so they race the
        # partition components without being part of the sum
        thieves["batchplane_queue_wait"] = verify_wait
        thieves["gossip_delay"] = (gossip_total * wall / total_wall
                                   if total_wall > 0 else 0.0)
        largest = max(thieves, key=thieves.get)
        straggler = max(lag_by_node, key=lag_by_node.get, default=None)
        slow_prop = max(propose_by_node, key=propose_by_node.get,
                        default=None)
        ranges.append({
            "heights": [chunk[0]["height"], chunk[-1]["height"]],
            "wall_s": wall,
            "stages": stages,
            "partition_residual_s": residual,
            "verify_wait_s": verify_wait,
            "thieves": thieves,
            "largest_thief": largest,
            "largest_thief_s": thieves[largest],
            "straggler_node": straggler,
            "straggler_lag_s": lag_by_node.get(straggler, 0.0),
            "slowest_propose_node": slow_prop,
        })
    global_thieves: dict[str, float] = {}
    for r in ranges:
        for k, v in r["thieves"].items():
            global_thieves[k] = global_thieves.get(k, 0.0) + v
    largest = (max(global_thieves, key=global_thieves.get)
               if global_thieves else None)
    return {
        "schema": CONSENSUS_DOCTOR_SCHEMA,
        "nodes": timeline.get("nodes", []),
        "height_range": timeline.get("height_range", [0, 0]),
        "height_count": len(heights),
        "wall_s": total_wall,
        "stage_stats": timeline.get("stage_stats", {}),
        "wall_p99": timeline.get("wall_p99", 0.0),
        "ranges": ranges,
        "thieves": global_thieves,
        "largest_thief": largest,
        "largest_thief_s": global_thieves.get(largest, 0.0),
        "partition_residual_s": residual_max,
        "sums_to_wall": residual_max <= _RESIDUAL_TOL,
        "gossip": gossip,
    }


def render_consensus_report(report: dict) -> str:
    """Human-readable rendering of a consensus_doctor report."""
    lines = []
    lo, hi = report.get("height_range", [0, 0])
    lines.append(
        f"consensus doctor: heights {lo}..{hi} "
        f"({report.get('height_count', 0)} committed, "
        f"{report.get('wall_s', 0.0):.3f}s wall, "
        f"{len(report.get('nodes', []))} nodes)")
    ok = "holds" if report.get("sums_to_wall") else "VIOLATED"
    lines.append(f"  sums-to-wall {ok} "
                 f"(max residual {report.get('partition_residual_s', 0):.2e})")
    for s, st in report.get("stage_stats", {}).items():
        lines.append(f"  stage {s:<9s} p50 {st['p50']*1e3:8.1f}ms  "
                     f"p99 {st['p99']*1e3:8.1f}ms  "
                     f"total {st['total_s']:8.3f}s")
    if report.get("largest_thief"):
        lines.append(f"  largest thief: {report['largest_thief']} "
                     f"({report.get('largest_thief_s', 0.0):.3f}s)")
    for r in report.get("ranges", ()):
        a, b = r["heights"]
        who = r.get("straggler_node")
        extra = f", straggler {who}" if who else ""
        lines.append(f"  [{a}..{b}] wall {r['wall_s']:.3f}s -> "
                     f"{r['largest_thief']} "
                     f"({r['largest_thief_s']:.3f}s{extra})")
    g = report.get("gossip") or {}
    if g.get("count"):
        lines.append(f"  gossip: {g['count']} deliveries, "
                     f"p99 {g.get('p99', 0.0)*1e3:.2f}ms, "
                     f"worst link {g.get('worst_link')} "
                     f"({g.get('max_s', 0.0)*1e3:.2f}ms)")
    return "\n".join(lines)
