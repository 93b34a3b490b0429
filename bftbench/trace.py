"""The device trace of a run's window, on the host's clock.

`torch.profiler` records the card's kernels and copies (CUDA activity)
and, so that they can be placed on `time.perf_counter`'s axis beside the
host's spans, one CPU marker whose host time is read around it.  Host
spans come from the program's flight recorder and from the harness's
own timers; an idle gap of the card is labelled by the innermost host
span around its middle.
"""

from __future__ import annotations

import time

MARK = "bftbench.clock"


class DeviceTrace:
    """Context manager: profiles the block; `events` are then
    (name, start, end) of every device operation (kernels, copies and
    sets), in perf_counter seconds, sorted by start."""

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function
        self._card = torch.cuda.is_available()
        self._prof = profile(activities=[ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if self._card else []))
        self._prof.__enter__()
        h0 = time.perf_counter()
        with record_function(MARK):
            pass
        self._host_mark = (h0 + time.perf_counter()) / 2
        self.events = []
        return self

    def __exit__(self, *exc):
        import torch
        from torch.autograd import DeviceType
        if self._card:
            torch.cuda.synchronize()
        self._prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        events = self._prof.events()
        mark = next(e for e in events if e.name == MARK)
        off = self._host_mark - (mark.time_range.start +
                                 mark.time_range.end) / 2e6
        # a `record_function` range shows on the device's timeline too,
        # as a user annotation over the operations it launched: not one
        self.events = sorted(
            (e.name, e.time_range.start / 1e6 + off,
             e.time_range.end / 1e6 + off)
            for e in events if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False))
        return False


def busy_intervals(events, t0: float, t1: float) -> list:
    """The union of the device operations' intervals inside [t0, t1]."""
    out = []
    for _, a, b in sorted(events, key=lambda e: e[1]):
        a, b = max(a, t0), min(b, t1)
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def busy_s(events, t0: float, t1: float) -> float:
    return sum(b - a for a, b in busy_intervals(events, t0, t1))


def gaps(events, t0: float, t1: float) -> list:
    """(start, end) of each stretch in [t0, t1] with no device operation."""
    out, at = [], t0
    for a, b in busy_intervals(events, t0, t1):
        if a > at:
            out.append((at, a))
        at = b
    if t1 > at:
        out.append((at, t1))
    return out


def label(spans, t: float) -> str:
    """The name of the shortest host span (name, start, end, ...) around
    t."""
    best = None
    for name, a, b, *_ in spans:
        if a <= t <= b and (best is None or b - a < best[2] - best[1]):
            best = (name, a, b)
    return best[0] if best else "other"


def breakdown(events, spans, t0: float, t1: float) -> dict:
    """The ten device operations with the most device time, and the idle
    time of the card summed by what the host was doing (the innermost
    host span at each gap's middle), the ten largest."""
    ops = {}
    for name, a, b in events:
        a, b = max(a, t0), min(b, t1)
        if b > a:
            ops[name] = ops.get(name, 0.0) + (b - a)
    idle = {}
    for a, b in gaps(events, t0, t1):
        key = label(spans, (a + b) / 2)
        idle[key] = idle.get(key, 0.0) + (b - a)
    top = lambda d: [[k, v] for k, v in sorted(  # noqa: E731
        d.items(), key=lambda kv: -kv[1])[:10]]
    return {"device_ops": top(ops), "idle_gaps": top(idle)}


def recorder_spans(snapshot: list) -> list:
    """Flight-recorder spans (the `snapshot()` form) as (name, start,
    end, args) in perf_counter seconds."""
    from tendermint_tpu_torch.utils import tracing
    t0 = tracing.perf_to_epoch(0.0)
    return [(s["name"], s["ts"] - t0, s["ts"] - t0 + s["dur"],
             s.get("args", {}))
            for s in snapshot if s.get("ph") == "X"]
