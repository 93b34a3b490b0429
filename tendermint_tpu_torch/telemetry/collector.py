"""Mesh collector: merge per-node height lifecycles into one waterfall.

Input is the canonical lifecycle record `_finish_height` emits::

    {"node": "n3", "height": 7, "round": 0, "proposer": "ab12..",
     "t_start": ..., "t_proposal": ..., "t_prevote": ...,
     "t_precommit": ..., "t_commit": ..., "verify_wait_s": ...}

The five timestamps are a monotone cut sequence, so the four stage
durations (STAGES) partition [t_start, t_commit] exactly — the merge
preserves that sums-to-wall invariant per node and the timeline's
representative row inherits it (`utils/attribution.py` discipline).

Records arrive three ways: in-process from a rig
(`collect_mesh`), over RPC as per-node dumps with a wall-clock sample
for skew normalization (`merge_dumps`), or offline by re-deriving them
from the `consensus.stage.*` spans in a dumped Chrome trace
(`records_from_spans`).  Malformed input degrades PER NODE/RECORD —
a truncated dump drops that node's rows, never the mesh waterfall.

Copy of `tendermint_tpu/telemetry/collector.py`: the same records,
merge, timeline and Chrome trace, so dumps cross between the packages
unchanged.  `collect_mesh` takes the port's in-process rigs: a list of
`ConsensusState`s (or of nodes holding one as `.consensus`), or an
object with `timeline_records()` as the JAX rig has.
"""

from __future__ import annotations

from tendermint_tpu_torch.utils import tracing
from tendermint_tpu_torch.utils.metrics import REGISTRY

TIMELINE_SCHEMA = "tpu-bft-timeline/1"

# stage k spans [CUTS[k], CUTS[k+1]] of the record's timestamp sequence
STAGES = ("propose", "prevote", "precommit", "commit")
_CUTS = ("t_start", "t_proposal", "t_prevote", "t_precommit", "t_commit")


def percentile(vals: list[float], q: float) -> float:
    """Exact empirical quantile (same index rule as the WireMesh
    commit_latency_p99): 0.0 on empty input."""
    if not vals:
        return 0.0
    s = sorted(vals)
    return s[min(len(s) - 1, int(q * len(s)))]


def normalize_record(raw, offset_s: float = 0.0) -> dict | None:
    """Canonicalize one lifecycle record: coerce types, shift timestamps
    onto the collector's clock axis (minus `offset_s`), and re-clamp the
    cut sequence monotone.  None for anything malformed — the caller
    degrades per record, never corrupts the merge."""
    if not isinstance(raw, dict):
        return None
    try:
        rec = {
            "node": str(raw.get("node", "")),
            "height": int(raw["height"]),
            "round": int(raw.get("round", 0)),
            "proposer": str(raw.get("proposer", "")),
            "verify_wait_s": max(0.0, float(raw.get("verify_wait_s", 0.0))),
        }
        cuts = [float(raw[k]) - offset_s for k in _CUTS]
    except (KeyError, TypeError, ValueError):
        return None
    if rec["height"] < 1:
        return None
    for i in range(1, len(cuts)):
        cuts[i] = min(max(cuts[i], cuts[i - 1]), cuts[-1])
    if cuts[-1] < cuts[0]:
        return None
    rec.update(zip(_CUTS, cuts))
    return rec


def stage_durations(rec: dict) -> dict[str, float]:
    return {s: rec[hi] - rec[lo]
            for s, lo, hi in zip(STAGES, _CUTS, _CUTS[1:])}


def merge_dumps(dumps, ref_wall: float | None = None) -> dict:
    """Merge per-node dumps `{"node", "records", "wall_now"}` into one
    record list with clock-skew normalization.

    All dumps are collected at (approximately) one instant, so each
    node's `wall_now` SHOULD agree; the spread IS the clock skew.  The
    reference is `ref_wall` (the collector's own clock) or, absent
    that, the median wall_now; each node's records shift by its offset
    from the reference.  A node with no usable wall_now merges
    unshifted; a node whose records are missing/garbage is dropped and
    named in `dropped` — degrade per node, never corrupt the mesh.
    Duplicate (node, height) rows keep the earliest commit."""
    walls = []
    for d in dumps:
        try:
            walls.append(float(d["wall_now"]))
        except (KeyError, TypeError, ValueError):
            pass
    if ref_wall is None:
        ref_wall = percentile(walls, 0.5) if walls else 0.0
    records: dict[tuple[str, int], dict] = {}
    offsets: dict[str, float] = {}
    dropped: dict[str, str] = {}
    for i, d in enumerate(dumps):
        if not isinstance(d, dict):
            dropped[f"dump{i}"] = "not a dict"
            continue
        node = str(d.get("node") or f"dump{i}")
        try:
            off = float(d["wall_now"]) - ref_wall
        except (KeyError, TypeError, ValueError):
            off = 0.0
        raws = d.get("records")
        if not isinstance(raws, (list, tuple)) or not raws:
            dropped[node] = "empty or truncated record list"
            continue
        kept = 0
        for raw in raws:
            rec = normalize_record(raw, offset_s=off)
            if rec is None:
                continue
            if not rec["node"]:
                rec["node"] = node
            key = (rec["node"], rec["height"])
            cur = records.get(key)
            if cur is None or rec["t_commit"] < cur["t_commit"]:
                records[key] = rec
            kept += 1
        if kept:
            offsets[node] = off
        else:
            dropped[node] = "no valid records"
    return {"records": sorted(records.values(),
                              key=lambda r: (r["height"], r["node"])),
            "offsets": offsets, "dropped": dropped, "ref_wall": ref_wall}


def records_from_spans(spans) -> list[dict]:
    """Rebuild lifecycle records from `consensus.stage.*` /
    `consensus.height` flight-recorder spans (snapshot() or
    spans_from_chrome form) — the offline path for dumped traces."""
    by_key: dict[tuple[str, int], dict] = {}
    extra: dict[tuple[str, int], dict] = {}
    for s in spans:
        name = s.get("name", "")
        args = s.get("args") or {}
        if "height" not in args:
            continue
        try:
            key = (str(args.get("node", "")), int(args["height"]))
        except (TypeError, ValueError):
            continue
        if name == "consensus.height":
            extra[key] = {
                "round": args.get("round", 0),
                "proposer": args.get("proposer", ""),
                "verify_wait_s": args.get("verify_wait_s", 0.0)}
        elif name.startswith("consensus.stage."):
            stage = name[len("consensus.stage."):]
            if stage in STAGES:
                by_key.setdefault(key, {})[stage] = (
                    float(s.get("ts", 0.0)), float(s.get("dur", 0.0)))
    out = []
    for (node, height), stages in by_key.items():
        if len(stages) != len(STAGES):
            continue                       # truncated ring: partial height
        raw = {"node": node, "height": height,
               "t_start": stages["propose"][0]}
        t = stages["propose"][0]
        for stage, cut in zip(STAGES, _CUTS[1:]):
            ts, dur = stages[stage]
            t = max(t, ts + dur)
            raw[cut] = t
        raw.update(extra.get((node, height), {}))
        rec = normalize_record(raw)
        if rec is not None:
            out.append(rec)
    out.sort(key=lambda r: (r["height"], r["node"]))
    return out


def build_timeline(records, gossip: dict | None = None) -> dict:
    """The merged per-height waterfall.  Each height row carries every
    node's stage partition plus mesh aggregates; the representative is
    the FIRST committer (the node that defined the quorum's commit
    time), so the row's headline stages sum to its wall exactly."""
    rows: dict[int, list[dict]] = {}
    for rec in records:
        rows.setdefault(rec["height"], []).append(rec)
    heights = []
    stage_vals: dict[str, list[float]] = {s: [] for s in STAGES}
    wall_vals: list[float] = []
    for h in sorted(rows):
        per_node = {}
        rep = min(rows[h], key=lambda r: r["t_commit"])
        last = max(rows[h], key=lambda r: r["t_commit"])
        for rec in rows[h]:
            durs = stage_durations(rec)
            per_node[rec["node"]] = {
                "round": rec["round"],
                "t_start": rec["t_start"],
                "t_commit": rec["t_commit"],
                "wall_s": rec["t_commit"] - rec["t_start"],
                "stages": durs,
                "verify_wait_s": rec["verify_wait_s"],
            }
            for s, v in durs.items():
                stage_vals[s].append(v)
            wall_vals.append(rec["t_commit"] - rec["t_start"])
        heights.append({
            "height": h,
            "round": rep["round"],
            "proposer": rep["proposer"],
            "first_commit_node": rep["node"],
            "t_start": rep["t_start"],
            "t_commit": rep["t_commit"],
            "wall_s": rep["t_commit"] - rep["t_start"],
            "stages": stage_durations(rep),
            "verify_wait_s": rep["verify_wait_s"],
            "commit_spread_s": last["t_commit"] - rep["t_commit"],
            "last_commit_node": last["node"],
            "nodes": per_node,
        })
    stage_stats = {
        s: {"count": len(v), "total_s": sum(v),
            "p50": percentile(v, 0.50), "p99": percentile(v, 0.99)}
        for s, v in stage_vals.items()}
    return {
        "schema": TIMELINE_SCHEMA,
        "nodes": sorted({r["node"] for r in records}),
        "height_range": ([heights[0]["height"], heights[-1]["height"]]
                         if heights else [0, 0]),
        "heights": heights,
        "stage_stats": stage_stats,
        "wall_p99": percentile(wall_vals, 0.99),
        "gossip": gossip or {},
    }


def _mesh_records(mesh) -> list:
    """The raw lifecycle records of an in-process rig: its
    `timeline_records()`, or every state's `lifecycle` ring."""
    if hasattr(mesh, "timeline_records"):
        return list(mesh.timeline_records())
    out = []
    for n in mesh:
        cs = getattr(n, "consensus", n)
        out += list(cs.lifecycle)
    return out


def collect_mesh(mesh) -> dict:
    """One-call in-process collection from a rig: lifecycle records
    (already on one clock — same process) + gossip fan-out stats, when
    the rig keeps them, into a timeline."""
    records = [r for r in (normalize_record(x)
                           for x in _mesh_records(mesh))
               if r is not None]
    gossip = mesh.gossip_stats() if hasattr(mesh, "gossip_stats") else {}
    return build_timeline(records, gossip=gossip)


def feed_registry(timeline: dict) -> None:
    """Mirror a merged timeline onto /metrics: per-stage duration
    histograms (`consensus_stage_seconds{stage}`) and each node's last
    committed height (`timeline_node_height{node}`)."""
    last: dict[str, int] = {}
    for row in timeline.get("heights", ()):
        for node, cell in row.get("nodes", {}).items():
            for stage, dur in cell["stages"].items():
                REGISTRY.consensus_stage_seconds.labels(stage).observe(dur)
            if row["height"] > last.get(node, 0):
                last[node] = row["height"]
    for node, h in last.items():
        REGISTRY.timeline_node_height.labels(node).set(h)


def to_chrome_trace(timeline: dict) -> dict:
    """Chrome trace-event JSON with ONE TRACK PER NODE: pid 1, a tid
    per node with a thread_name metadata event, an X event per stage
    plus a `consensus.height` envelope per (node, height)."""
    nodes = timeline.get("nodes", [])
    tid_of = {node: i + 1 for i, node in enumerate(nodes)}
    events = []
    for row in timeline.get("heights", ()):
        for node, cell in row.get("nodes", {}).items():
            tid = tid_of.setdefault(node, len(tid_of) + 1)
            t = cell["t_start"]
            args = {"height": row["height"], "round": cell["round"],
                    "node": node}
            events.append({
                "name": "consensus.height", "ph": tracing.PH_SPAN,
                "pid": 1, "tid": tid, "cat": tracing.CAT_CONSENSUS,
                "ts": t * 1e6, "dur": cell["wall_s"] * 1e6,
                "args": {**args,
                         "verify_wait_s": round(cell["verify_wait_s"], 6)}})
            for stage in STAGES:
                dur = cell["stages"][stage]
                events.append({
                    "name": "consensus.stage." + stage,
                    "ph": tracing.PH_SPAN, "pid": 1, "tid": tid,
                    "cat": tracing.CAT_CONSENSUS,
                    "ts": t * 1e6, "dur": dur * 1e6,
                    "args": {**args, "stage": stage}})
                t += dur
    for node, tid in sorted(tid_of.items(), key=lambda kv: kv[1]):
        events.append({"name": "thread_name", "ph": "M", "pid": 1,
                       "tid": tid, "args": {"name": node}})
    events.append({"name": "process_name", "ph": "M", "pid": 1,
                   "args": {"name": "consensus-timeline"}})
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {"schema": timeline.get("schema",
                                                 TIMELINE_SCHEMA),
                          "nodes": nodes,
                          "height_range": timeline.get("height_range")}}
