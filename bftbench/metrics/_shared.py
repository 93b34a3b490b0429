"""What several readers share: the fast-sync passes that reached the
tip, the card's busy share, and K1's time against its least time."""

from __future__ import annotations

from bftbench.costs import k1
from bftbench.trace import busy_s


def whole_passes(ctx) -> list:
    """Fast-sync passes of the window whose honest replay ran to its
    end: the windows, the stages and the tip all in them."""
    return [p for p in ctx.records if p.complete and p.replay is not None]


def stage_ms_per_block(ctx, stage: str):
    """A stage's host seconds in the honest replays of the whole passes,
    per block applied, in ms."""
    ps = whole_passes(ctx)
    blocks = sum(p.height for p in ps)
    if not blocks:
        return None
    return sum(p.replay.busy_s[stage] for p in ps) / blocks * 1e3


def idle_share(ctx):
    """100 x the share of the window in which no operation ran on the
    card (kernels and copies, their union)."""
    if not ctx.events:
        return None
    return (1 - busy_s(ctx.events, ctx.t0, ctx.t1) / ctx.window_s) * 100


def k1_roofline(ctx):
    """100 x K1's least time over its device time in the window.  Each
    K1 launch is the backend's `verify.dispatch` span, whose `lanes` are
    the launch's real lanes: templated K1 over the configuration's
    `validators` keys, one 128-byte template per commit of them all
    (`costs/k1.py`, at the card's peaks).  None where the window holds
    no launch, where the trace's K1 kernels and the spans differ in
    number, or where the distinct table rows would be needed to bound a
    launch (bytes could bound it), which the spans do not give."""
    v = ctx.cell.config["validators"]
    lanes = [s[3]["lanes"] for s in ctx.spans
             if s[0] == "verify.dispatch" and ctx.t0 <= s[1] <= ctx.t1]
    times = [min(b, ctx.t1) - max(a, ctx.t0) for name, a, b in ctx.events
             if k1.KERNEL in name and a >= ctx.t0]
    if not times or len(times) != len(lanes):
        return None
    try:
        least = sum(k1.bound_s(n, 128, -(-n // v), v, rows=None)[0]
                    for n in lanes)
    except TypeError:           # rows() wanted: not countable from spans
        return None
    return least / sum(times) * 100


def backend_intervals(ctx, t0: float, t1: float) -> list:
    """The union, inside [t0, t1], of the backend's spans: staging and
    copies (`transfer.h2d`), launch (`verify.dispatch`) and the wait for
    the result (`verify.collect`)."""
    out = []
    for name, a, b, *_ in sorted(ctx.spans, key=lambda s: s[1]):
        if name not in ("transfer.h2d", "verify.dispatch", "verify.collect"):
            continue
        a, b = max(a, t0), min(b, t1)
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def backend_s(ctx, call) -> float:
    return sum(b - a for a, b in backend_intervals(ctx, call.t0, call.t1))
