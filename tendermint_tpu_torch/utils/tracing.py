"""Flight recorder: a thread-safe ring buffer of timed spans.

The device capture (`utils/trace.py start_device_trace`, on
`torch.profiler`) answers "what did the DEVICE do" at kernel
granularity, but only while an operator has a capture running.  The
flight recorder is the complement: an always-on, bounded record of what
the HOST planes did — consensus step transitions, device batch
dispatch/collect, WAL writes, fast-sync pool events, bench
fixture/replay phases — cheap enough to leave recording in production
(one lock + one list store per span) and dumpable after the fact, like
an aircraft FDR.

Spans are written with the context manager::

    with span("verify.dispatch", height=h, lanes=n):
        ...

or, for point events with no duration, ``instant("pool.evict", ...)``.

The buffer is a fixed-capacity ring (16384 spans, a constructor
argument of `FlightRecorder`): old spans are overwritten, never
reallocated, so the recorder's footprint is constant no matter how long the node runs.
`to_chrome_trace()` renders the Chrome trace-event JSON format that
Perfetto / chrome://tracing / TensorBoard all load, so a flight-recorder
dump and a `torch.profiler` device trace can be eyeballed side by side.

Served by the `debug_flight_recorder` RPC route (`rpc/routes.py`) and
the `trace` CLI subcommand.

Copy of `tendermint_tpu/utils/tracing.py`: the same span names,
categories and dump format, so each package's doctor reads the other's
dumps.  The port adds the `kernel.` prefix (category `compile`): the
kernel library's build and load, and each kernel's first launch.  A span
around a launch on the card times the enqueue, not the kernel: the
backend's `device`-category spans end after the host has the result.
"""

from __future__ import annotations

import json
import os
import threading
import time
from contextlib import contextmanager

# epoch anchor for perf_counter timestamps: spans carry wall-clock start
# times (so traces from different processes line up) but durations from
# the monotonic clock (so an NTP step mid-span cannot go negative)
_EPOCH_T0 = time.time() - time.perf_counter()

PH_SPAN = "X"        # Chrome "complete" event (ts + dur)
PH_INSTANT = "i"     # Chrome "instant" event


def perf_to_epoch(p: float) -> float:
    """Map a time.perf_counter() reading onto the recorder's wall-clock
    axis — for callers recording a span from timestamps they already
    took (e.g. reactor window accounting) instead of via span()."""
    return _EPOCH_T0 + p

# -- span categories ---------------------------------------------------------
# Every span carries a category so the attribution profiler
# (utils/attribution.py) can partition a replay window's wall clock into
# compile / transfer / device-busy / scalar / idle without knowing every
# span name.  Call sites may pass cat= explicitly; otherwise the name
# prefix decides (longest prefix wins).
CAT_PREP = "prep"          # host-side window assembly (hashing, lanes)
CAT_DISPATCH = "dispatch"  # host-side device enqueue (async upload+queue)
CAT_DEVICE = "device"      # wait-for-device-result / sync device calls
CAT_APPLY = "apply"        # host-side ABCI/store application
CAT_COMPILE = "compile"    # kernel library build / first launches
CAT_TRANSFER = "transfer"  # host<->device copies
CAT_SCALAR = "scalar"      # scalar/python fallback crypto
# Timeline-plane categories (telemetry/): consensus height-lifecycle
# stages and mesh-collector work.  These never appear in PARTITION so
# they cannot pollute the replay attribution; they exist so lifecycle
# spans are categorized (tmlint span-category) and filterable in traces.
CAT_CONSENSUS = "consensus"  # height lifecycle stages (propose..commit)
CAT_TELEMETRY = "telemetry"  # mesh collector / timeline merge work
# Deliberately-uncategorized: host bookkeeping spans (WAL writes,
# supervised-ladder wrappers whose inner spans carry the categories).
# Passing cat=CAT_NONE skips prefix inference AND keeps the span out of
# the attribution partition — unlike cat=None, which means "infer".
CAT_NONE = ""

_CAT_BY_PREFIX = (
    ("xla.", CAT_COMPILE),
    ("kernel.", CAT_COMPILE),
    ("transfer.", CAT_TRANSFER),
    ("scalar.", CAT_SCALAR),
    ("verify.dispatch", CAT_DISPATCH),
    ("verify.collect", CAT_DEVICE),
    ("fastsync.verify", CAT_DEVICE),
    ("bench.verify", CAT_DEVICE),
    ("verify.batch", CAT_DEVICE),
    ("verify.grouped", CAT_DEVICE),
    ("sign.batch", CAT_DEVICE),
    ("bench.prep", CAT_PREP),
    ("bench.dispatch", CAT_DISPATCH),
    ("bench.apply", CAT_APPLY),
    ("fastsync.prepare", CAT_PREP),
    ("fastsync.lookahead", CAT_PREP),
    ("fastsync.apply", CAT_APPLY),
    # timeline plane: lifecycle stages + collector.  consensus spans that
    # ARE device/apply work (vote_microbatch, apply) pass cat= explicitly
    # at the call site, which always wins over this prefix.
    ("consensus.", CAT_CONSENSUS),
    ("telemetry.", CAT_TELEMETRY),
)


def now_epoch() -> float:
    """Current time on the recorder's wall-clock axis (monotonic clock
    anchored to the epoch once at import).  Use this — not time.time() —
    to stamp p2p envelopes: an NTP step mid-run cannot make two stamps
    from the same process go backwards."""
    return _EPOCH_T0 + time.perf_counter()


def default_category(name: str) -> str | None:
    """Category inferred from a span name, or None when no rule matches
    (uncategorized spans simply don't participate in attribution)."""
    for prefix, cat in _CAT_BY_PREFIX:
        if name.startswith(prefix):
            return cat
    return None


class FlightRecorder:
    """Fixed-capacity ring of span records, oldest overwritten first.

    A record is the tuple (name, ph, ts_s, dur_s, tid, tname, cat, lane,
    args): wall-clock start, monotonic duration, originating thread,
    attribution category, and lane (the logical thread/stream the work
    ran on — defaults to the recording thread's name).  Tuples (not
    dicts) keep the hot-path allocation to one object."""

    def __init__(self, capacity: int = 16384):
        if capacity < 1:
            raise ValueError("flight recorder capacity must be >= 1")
        self.capacity = capacity
        self._buf: list = [None] * capacity
        self._head = 0                    # next write slot
        self._total = 0                   # spans ever recorded
        self._lock = threading.Lock()

    # -- recording -------------------------------------------------------
    def record(self, name: str, ts_s: float, dur_s: float,
               args: dict | None = None, ph: str = PH_SPAN,
               cat: str | None = None, lane: str | None = None) -> None:
        t = threading.current_thread()
        if cat is None:
            cat = default_category(name)
        rec = (name, ph, ts_s, dur_s, t.ident or 0, t.name, cat,
               lane or t.name, args or None)
        with self._lock:
            self._buf[self._head] = rec
            self._head = (self._head + 1) % self.capacity
            self._total += 1

    @contextmanager
    def span(self, name: str, cat: str | None = None,
             lane: str | None = None, **args):
        """Time a block; the span is recorded even when the block raises
        (a span that vanishes on failure hides exactly the interesting
        case), with error=<type> appended to its args.  `cat` and `lane`
        are reserved keywords feeding the attribution profiler; every
        other keyword lands in the span's args."""
        p0 = time.perf_counter()
        try:
            yield
        except BaseException as e:
            args = {**args, "error": type(e).__name__}
            raise
        finally:
            self.record(name, _EPOCH_T0 + p0, time.perf_counter() - p0,
                        args, cat=cat, lane=lane)

    def instant(self, name: str, **args) -> None:
        self.record(name, _EPOCH_T0 + time.perf_counter(), 0.0, args,
                    ph=PH_INSTANT)

    # -- reading ---------------------------------------------------------
    def snapshot(self) -> list[dict]:
        """Spans oldest-first as dicts (RPC / CLI serialization form)."""
        with self._lock:
            if self._total >= self.capacity:
                recs = self._buf[self._head:] + self._buf[:self._head]
            else:
                recs = self._buf[:self._head]
        return [{"name": n, "ph": ph, "ts": ts, "dur": dur,
                 "tid": tid, "thread": tname, "lane": lane,
                 **({"cat": cat} if cat else {}),
                 **({"args": args} if args else {})}
                for rec in recs if rec is not None
                for (n, ph, ts, dur, tid, tname, cat, lane, args)
                in (rec,)]

    def recent(self, n: int) -> list[dict]:
        """The `n` most recent spans, oldest-first, in the snapshot()
        form; the port's per-window metrics read their window's spans
        here without copying the whole ring."""
        with self._lock:
            k = min(n, self._total, self.capacity)
            idx = [(self._head - k + i) % self.capacity for i in range(k)]
            recs = [self._buf[i] for i in idx]
        return [{"name": nm, "ph": ph, "ts": ts, "dur": dur,
                 "tid": tid, "thread": tname, "lane": lane,
                 **({"cat": cat} if cat else {}),
                 **({"args": args} if args else {})}
                for (nm, ph, ts, dur, tid, tname, cat, lane, args) in recs]

    def last(self, name: str) -> dict | None:
        """Most recent span with `name` (bench's budget manager reads the
        last fixture-build cost here), or None."""
        for rec in reversed(self.snapshot()):
            if rec["name"] == name:
                return rec
        return None

    @property
    def total(self) -> int:
        return self._total

    @property
    def dropped(self) -> int:
        return max(0, self._total - self.capacity)

    def clear(self) -> None:
        with self._lock:
            self._buf = [None] * self.capacity
            self._head = 0
            self._total = 0

    # -- export ----------------------------------------------------------
    def to_chrome_trace(self) -> dict:
        """Chrome trace-event JSON (the format Perfetto, chrome://tracing
        and TensorBoard's trace viewer load): one "X" complete event per
        span (ts/dur in MICROseconds), "i" instants, plus one "M"
        thread_name metadata event per thread seen."""
        pid = os.getpid()
        events = []
        threads: dict[int, str] = {}
        for rec in self.snapshot():
            tid = rec["tid"]
            threads.setdefault(tid, rec["thread"])
            ev = {"name": rec["name"], "ph": rec["ph"], "pid": pid,
                  "tid": tid, "ts": rec["ts"] * 1e6}
            if "cat" in rec:
                ev["cat"] = rec["cat"]
            if rec["ph"] == PH_SPAN:
                ev["dur"] = rec["dur"] * 1e6
            else:
                ev["s"] = "t"            # instant scope: thread
            if "args" in rec:
                ev["args"] = rec["args"]
            events.append(ev)
        for tid, tname in threads.items():
            events.append({"name": "thread_name", "ph": "M", "pid": pid,
                           "tid": tid, "args": {"name": tname}})
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "otherData": {"recorder_total": self._total,
                              "recorder_dropped": self.dropped}}

    def dump(self, path: str) -> str:
        """Atomically write the Chrome trace JSON to `path` (tmp +
        rename: a dump interrupted by the very signal that triggered it
        must not leave a truncated file)."""
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.to_chrome_trace(), f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        return path


RECORDER = FlightRecorder(16384)

span = RECORDER.span
instant = RECORDER.instant
