"""Pipeline attribution: where did the wall clock go?

The flight recorder (utils/tracing.py) answers "what spans ran"; this
module answers the scoreboard's question — for a replay window (or a
whole bench run), how much wall clock was kernel build, host<->device
transfer, device-busy compute, scalar-fallback crypto, and how much was
the device simply sitting IDLE.  Blockchain Machine (arXiv:2104.06968)
treats per-stage rate instrumentation as a first-class contribution of a
hardware BFT pipeline; this is that layer for the crypto hot path.

The accounting is a *priority partition*: every instant of a window is
attributed to exactly one category, highest priority first

    compile > transfer > device > scalar > idle

so the components always sum to the window's wall clock (the acceptance
bar: within 10% — here it holds to float rounding, by construction).
An instant covered by both a compile span and a device span counts as
compile: when the executable is being built, the device time underneath
is not productive verify throughput.

Overlap fraction is reported separately: the share of the window where
at least two of the prep / device / apply stages ran concurrently — 1.0
means a perfectly pipelined window, 0.0 a fully serial one (the round-5
failure shape: prep, verify, apply each running alone).

All functions take the span-dict form `FlightRecorder.snapshot()`
returns, so the doctor runs on a dump from any host.

Copy of `tendermint_tpu/utils/attribution.py`: the same partition,
report and `tpu-bft-doctor/1` schema, so a report from either package's
dump is the same document.  On the port the `compile` category holds the
kernel library's build and each kernel's first launch, and `device` the
host's wait for a result from the card (`verify.collect` on the
asynchronous route, the whole call until its result is on the host on
the synchronous ones).
"""

from __future__ import annotations

from tendermint_tpu_torch.utils import tracing

# priority order of the exclusive partition (idle = remainder)
PARTITION = (tracing.CAT_COMPILE, tracing.CAT_TRANSFER,
             tracing.CAT_DEVICE, tracing.CAT_SCALAR)

# report keys for the partition, in the same order
_REPORT_KEY = {tracing.CAT_COMPILE: "compile",
               tracing.CAT_TRANSFER: "transfer",
               tracing.CAT_DEVICE: "device_busy",
               tracing.CAT_SCALAR: "scalar_tail"}

DOCTOR_SCHEMA = "tpu-bft-doctor/1"


# ---------------------------------------------------------------------------
# interval arithmetic — closed-open [start, end) second intervals
# ---------------------------------------------------------------------------

def merge(intervals) -> list[tuple[float, float]]:
    """Union of intervals as a sorted, disjoint list."""
    ivs = sorted((s, e) for s, e in intervals if e > s)
    out: list[tuple[float, float]] = []
    for s, e in ivs:
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def total(intervals) -> float:
    return sum(e - s for s, e in intervals)


def clip(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    """Intervals intersected with the window [lo, hi)."""
    return [(max(s, lo), min(e, hi)) for s, e in intervals
            if min(e, hi) > max(s, lo)]


def subtract(a, b) -> list[tuple[float, float]]:
    """a minus b; both merged-disjoint, result merged-disjoint."""
    out = []
    bi = list(b)
    for s, e in a:
        cur = s
        for bs, be in bi:
            if be <= cur or bs >= e:
                continue
            if bs > cur:
                out.append((cur, bs))
            cur = max(cur, be)
            if cur >= e:
                break
        if cur < e:
            out.append((cur, e))
    return out


def intersect(a, b) -> list[tuple[float, float]]:
    """a intersect b; both merged-disjoint."""
    out, i, j = [], 0, 0
    a, b = list(a), list(b)
    while i < len(a) and j < len(b):
        s = max(a[i][0], b[j][0])
        e = min(a[i][1], b[j][1])
        if e > s:
            out.append((s, e))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def covered_by_at_least(interval_lists, k: int) -> list[tuple[float, float]]:
    """Region covered by >= k of the given (merged) interval lists —
    boundary sweep over all edges.  Used for the pipeline overlap
    fraction (k=2 over prep/device/apply)."""
    edges = []
    for ivs in interval_lists:
        for s, e in ivs:
            edges.append((s, 1))
            edges.append((e, -1))
    edges.sort()
    out, depth, start = [], 0, None
    for t, d in edges:
        prev = depth
        depth += d
        if prev < k <= depth:
            start = t
        elif prev >= k > depth and start is not None:
            if t > start:
                out.append((start, t))
            start = None
    return merge(out)


# ---------------------------------------------------------------------------
# span plumbing
# ---------------------------------------------------------------------------

def spans_from_chrome(doc: dict) -> list[dict]:
    """Span dicts (the snapshot() form) from a Chrome trace-event JSON
    document (`FlightRecorder.to_chrome_trace()` / `dump()` output), so
    the doctor runs offline on a dumped trace file."""
    out = []
    for ev in doc.get("traceEvents", ()):
        ph = ev.get("ph")
        if ph not in (tracing.PH_SPAN, tracing.PH_INSTANT):
            continue                        # skip metadata events
        s = {"name": ev.get("name", ""), "ph": ph,
             "ts": ev.get("ts", 0.0) / 1e6,
             "dur": ev.get("dur", 0.0) / 1e6,
             "tid": ev.get("tid", 0), "thread": "", "lane": ""}
        if "cat" in ev:
            s["cat"] = ev["cat"]
        if "args" in ev:
            s["args"] = ev["args"]
        out.append(s)
    return out


def spans_by_category(spans) -> dict[str, list[tuple[float, float]]]:
    """Merged intervals per category over a span-dict list.  Spans with
    no category (explicit or name-derived) are ignored."""
    raw: dict[str, list] = {}
    for s in spans:
        if s.get("ph") != tracing.PH_SPAN or s["dur"] <= 0:
            continue
        cat = s.get("cat") or tracing.default_category(s["name"])
        if cat is None:
            continue
        raw.setdefault(cat, []).append((s["ts"], s["ts"] + s["dur"]))
    return {c: merge(ivs) for c, ivs in raw.items()}


def find_windows(spans, key: str = "window") -> dict:
    """Group spans carrying `key` in their args; a window's interval is
    [earliest start, latest end] over its member spans.  Returns
    {window_id: (lo, hi)} sorted by lo."""
    groups: dict = {}
    for s in spans:
        args = s.get("args") or {}
        if key not in args or s.get("ph") != tracing.PH_SPAN:
            continue
        w = args[key]
        lo, hi = s["ts"], s["ts"] + s["dur"]
        if w in groups:
            groups[w] = (min(groups[w][0], lo), max(groups[w][1], hi))
        else:
            groups[w] = (lo, hi)
    return dict(sorted(groups.items(), key=lambda kv: kv[1][0]))


def attribute_interval(cat_ivs: dict, lo: float, hi: float) -> dict:
    """Priority-partition [lo, hi): each instant goes to the highest-
    priority category covering it; the uncovered remainder is idle.
    Components sum to wall exactly (float rounding aside)."""
    wall = hi - lo
    remaining = [(lo, hi)]
    out = {"wall": wall}
    for cat in PARTITION:
        cover = clip(cat_ivs.get(cat, ()), lo, hi)
        taken = intersect(remaining, cover)
        out[_REPORT_KEY[cat]] = total(taken)
        remaining = subtract(remaining, cover)
    out["device_idle"] = total(remaining)
    # pipeline stats (not part of the partition): stage unions + overlap
    prep = clip(cat_ivs.get(tracing.CAT_PREP, ()), lo, hi)
    dev = clip(cat_ivs.get(tracing.CAT_DEVICE, ()), lo, hi)
    apply_ = clip(cat_ivs.get(tracing.CAT_APPLY, ()), lo, hi)
    out["prep_seconds"] = total(prep)
    out["apply_seconds"] = total(apply_)
    out["overlap_fraction"] = (
        total(covered_by_at_least([merge(prep), merge(dev),
                                   merge(apply_)], 2)) / wall
        if wall > 0 else 0.0)
    return out


def window_attribution(spans, key: str = "window") -> list[dict]:
    """Per-window attribution table: one partition dict per window id
    found under `key` (category intervals come from ALL spans — compile
    or transfer spans need not carry the window arg to be attributed to
    the window they overlap)."""
    cat_ivs = spans_by_category(spans)
    out = []
    for w, (lo, hi) in find_windows(spans, key).items():
        row = attribute_interval(cat_ivs, lo, hi)
        row["window"] = w
        row["start"] = lo
        out.append(row)
    return out


def overlap_summary(rows: list[dict]) -> dict:
    """Collapse a `window_attribution` table into the three numbers a
    replay result carries: window count, wall-weighted mean
    overlap_fraction, and the worst window's overlap.  The weighting
    matters — a pipeline that overlaps beautifully on short windows and
    serializes on the long ones must not report a flattering mean."""
    rows = [r for r in rows if (r.get("wall") or 0.0) > 0]
    if not rows:
        return {"windows": 0, "overlap_fraction": 0.0,
                "min_window_overlap": 0.0}
    wall = sum(r["wall"] for r in rows)
    mean = sum(r["overlap_fraction"] * r["wall"] for r in rows) / wall
    return {"windows": len(rows),
            "overlap_fraction": round(mean, 4),
            "min_window_overlap": round(
                min(r["overlap_fraction"] for r in rows), 4)}


def observe_window_metrics(attr: dict) -> None:
    """Feed one window's attribution into the Prometheus histograms so
    a scrape sees the pipeline health without running the doctor."""
    from tendermint_tpu_torch.utils.metrics import REGISTRY
    wall = attr.get("wall") or 0.0
    if wall <= 0:
        return
    REGISTRY.window_overlap_frac_hist.observe(attr["overlap_fraction"])
    REGISTRY.window_device_busy_frac_hist.observe(
        attr["device_busy"] / wall)
    REGISTRY.window_device_idle_frac_hist.observe(
        attr["device_idle"] / wall)
    REGISTRY.window_scalar_seconds.observe(attr["scalar_tail"])


# ---------------------------------------------------------------------------
# the doctor report
# ---------------------------------------------------------------------------

# components a faster pipeline would claw back (device_busy is the
# productive part; everything else is the gap)
_THIEVES = ("compile", "device_idle", "transfer", "scalar_tail")


def batchplane_summary(metrics: dict) -> dict | None:
    """Batch-plane coalescing health from a `REGISTRY.snapshot()` dict:
    how full the flushed chunks ran, who filled them, and why they
    shipped.  None when the plane never flushed (nothing to say).

    `half_full_stolen_seconds` is added by `doctor_report`: device-busy
    time estimated wasted on padding lanes, device_busy * (1 - mean
    occupancy) — the padded tail of a chunk costs the same device time
    as the real lanes, so a plane flushing half-full burns about half
    its device-busy seconds verifying zeros."""
    occ = metrics.get("batchplane_occupancy") or {}
    flushes = metrics.get("batchplane_flushes") or 0
    if not flushes or not occ.get("count"):
        return None
    return {
        "flushes": flushes,
        "mixed_batches": metrics.get("batchplane_mixed_batches", 0),
        "occupancy_mean": round(occ["sum"] / occ["count"], 4),
        "occupancy_p50": occ.get("p50"),
        "flush_reason": dict(metrics.get("batchplane_flush_reason") or {}),
        "lanes_by_producer": dict(metrics.get("batchplane_lanes") or {}),
        "wait_seconds": metrics.get("batchplane_wait_seconds") or {},
    }


def doctor_report(spans, key: str = "window",
                  regressions: dict | None = None,
                  metrics: dict | None = None) -> dict:
    """Machine-readable attribution report over a span dump.

    `headline_gap` sums the partition across all windows (falling back
    to the full span extent when no window-keyed spans exist), and
    `largest_thief` names the single biggest non-productive component —
    the first thing to fix on the road back to the 20x target.
    `regressions` (from utils/ledger.py) is folded in verbatim so one
    document answers both "where did the time go" and "did we get
    slower".  `metrics` (a `REGISTRY.snapshot()` dict) adds the batch
    plane's coalescing health and lets half-full batches compete as a
    named thief — padding lanes burn device-busy time the partition
    alone would misread as productive."""
    windows = window_attribution(spans, key)
    cat_ivs = spans_by_category(spans)
    if windows:
        gap = {k: sum(w[k] for w in windows)
               for k in ("wall", "compile", "transfer", "device_busy",
                         "scalar_tail", "device_idle")}
        overlap = (sum(w["overlap_fraction"] * w["wall"] for w in windows)
                   / gap["wall"]) if gap["wall"] > 0 else 0.0
    else:
        # no window-keyed spans: attribute the whole recorded extent
        ext = [(s["ts"], s["ts"] + s["dur"]) for s in spans
               if s.get("ph") == tracing.PH_SPAN and s["dur"] > 0]
        if ext:
            lo = min(s for s, _ in ext)
            hi = max(e for _, e in ext)
            gap = attribute_interval(cat_ivs, lo, hi)
            overlap = gap.pop("overlap_fraction")
            gap.pop("prep_seconds", None)
            gap.pop("apply_seconds", None)
        else:
            gap = {k: 0.0 for k in ("wall", "compile", "transfer",
                                    "device_busy", "scalar_tail",
                                    "device_idle")}
            overlap = 0.0
    gap = {k: round(v, 4) for k, v in gap.items()}
    thief_pool = {k: gap.get(k, 0.0) for k in _THIEVES}
    plane = batchplane_summary(metrics) if metrics else None
    if plane is not None:
        # half-full batches steal from INSIDE device_busy: the padded
        # chunk tail costs real device time, so it races the partition
        # components as its own thief rather than adding to the sum
        plane["half_full_stolen_seconds"] = round(
            gap.get("device_busy", 0.0) * (1.0 - plane["occupancy_mean"]),
            4)
        thief_pool["half_full_batches"] = plane["half_full_stolen_seconds"]
    thief = max(thief_pool, key=lambda k: thief_pool[k])
    report = {
        "schema": DOCTOR_SCHEMA,
        "span_count": len(spans),
        "window_count": len(windows),
        "headline_gap": gap,
        "overlap_fraction": round(overlap, 4),
        "largest_thief": (thief if thief_pool.get(thief, 0.0) > 0
                          else None),
        "windows": [{k: (round(v, 4) if isinstance(v, float) else v)
                     for k, v in w.items()} for w in windows],
    }
    if plane is not None:
        report["batchplane"] = plane
    if regressions is not None:
        report["regressions"] = regressions
    return report


def render_report(report: dict) -> str:
    """Human summary of a doctor report — one paragraph an operator can
    read off a terminal, naming the largest thief first."""
    gap = report["headline_gap"]
    plane = report.get("batchplane") or {}
    wall = gap.get("wall") or 0.0
    lines = []
    thief = report.get("largest_thief")
    if thief and wall > 0:
        stolen = (plane.get("half_full_stolen_seconds", 0.0)
                  if thief == "half_full_batches" else gap[thief])
        pct = 100.0 * stolen / wall
        lines.append(
            f"largest thief: {thief} ({stolen:.1f}s, {pct:.0f}% of "
            f"{wall:.1f}s window wall clock)")
    elif wall > 0:
        lines.append(f"no attributable gap found in {wall:.1f}s of "
                     "window wall clock")
    else:
        lines.append("no spans to attribute (empty flight recorder?)")
    if wall > 0:
        parts = ", ".join(
            f"{k}={gap.get(k, 0.0):.1f}s"
            for k in ("compile", "transfer", "device_busy", "scalar_tail",
                      "device_idle"))
        lines.append(f"partition: {parts}")
        lines.append(f"pipeline overlap fraction: "
                     f"{report['overlap_fraction']:.2f} over "
                     f"{report['window_count']} window(s)")
    if plane:
        reasons = ", ".join(f"{k}={v}" for k, v in
                            sorted(plane["flush_reason"].items()))
        lines.append(
            f"batch plane: {plane['flushes']} flushes "
            f"({plane['mixed_batches']} mixed-producer), occupancy "
            f"mean {plane['occupancy_mean']:.2f}, ~"
            f"{plane.get('half_full_stolen_seconds', 0.0):.1f}s burned "
            f"on padding lanes"
            + (f" [{reasons}]" if reasons else ""))
    regs = report.get("regressions") or {}
    flagged = {k: v for k, v in regs.items()
               if isinstance(v, dict) and v.get("regression")}
    for cfg, r in sorted(flagged.items()):
        lines.append(
            f"REGRESSION {cfg}: {r['rate']:.1f} {r.get('unit', '')} vs "
            f"best prior {r['best_prior']:.1f} "
            f"({100 * r['delta_frac']:+.1f}%)")
    return "\n".join(lines)
