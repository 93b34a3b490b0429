"""First-class runtime metrics — "the benchmark currency" (SURVEY.md §5).

The reference's observability is events + RPC snapshots; this framework
additionally counts the quantities its design is judged on: blocks
committed/s, signatures verified/s, verify-batch occupancy (how full the
padded device batches run), and device step latency.

Global registry, lock-per-instrument, exposed as one dict via
`snapshot()` for the `status` / `dump_consensus_state` RPC routes and for
bench harnesses.

Copy of `tendermint_tpu/utils/metrics.py` with every series name kept, so
a scrape of a port node has the JAX node's series.  Where the JAX package
counts XLA compiles, the `xla_*` series count what takes their place on
the card: `xla_compiles` / `xla_compile_seconds` the builds and loads of
the kernel library (`ops/kernels.library`: `nvcc` on a cold `build/`, a
`dlopen` on a warm one), `xla_first_call_seconds` each kernel's first
launch, and `xla_cache_hits` / `xla_cache_misses` / `xla_recompiles`
the backend's launches on a bucket shape it has seen, has not seen, and
has not seen on a kernel that ran before.  The crypto ladder's rung
label is `cuda` where the JAX package writes `tpu`.  Metrics are written
and read out; no decision of the port reads them.
"""

from __future__ import annotations

import threading
import time

from tendermint_tpu_torch import __version__


class Counter:
    __slots__ = ("_v", "_lock")

    def __init__(self):
        self._v = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._v += n

    @property
    def value(self) -> int:
        return self._v


class Gauge:
    __slots__ = ("_v", "_lock")

    def __init__(self):
        self._v = 0.0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self._v = v

    @property
    def value(self) -> float:
        return self._v


class Summary:
    """Streaming mean/min/max with exponential decay toward recent
    samples.  `min` matters for breakeven decisions: the first sample of
    a device-call summary includes the kernel build, so the mean starts
    wildly inflated while the min converges to the steady per-call cost
    after one warm call."""
    __slots__ = ("_mean", "_min", "_max", "_n", "_lock", "alpha")

    def __init__(self, alpha: float = 0.1):
        self._mean = 0.0
        self._min = 0.0
        self._max = 0.0
        self._n = 0
        self._lock = threading.Lock()
        self.alpha = alpha

    def observe(self, v: float) -> None:
        with self._lock:
            self._n += 1
            if self._n == 1:
                self._mean = v
                self._min = v
            else:
                self._mean += self.alpha * (v - self._mean)
                if v < self._min:
                    self._min = v
            if v > self._max:
                self._max = v

    @property
    def mean(self) -> float:
        return self._mean

    @property
    def count(self) -> int:
        return self._n

    @property
    def min(self) -> float:
        return self._min


class Histogram:
    """Fixed-bucket histogram: counts per upper bound plus sum/count, the
    Prometheus histogram layout.  Unlike `Summary` (decayed mean — good
    for steering heuristics, blind to tails) this answers the questions a
    benchmark scoreboard asks: p50/p90/p99 device step latency, batch
    occupancy distribution, round duration spread.  Quantiles are the
    standard bucket interpolation — exact bucket, linear within it."""

    # latency bounds (seconds): 100us .. 10s, the device-call range
    LATENCY_BOUNDS = (0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005,
                      0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
                      10.0)
    # ratio bounds: batch occupancy lives in (0, 1]
    RATIO_BOUNDS = (0.05, 0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9,
                    0.95, 1.0)
    # wall-clock bounds (seconds): consensus round durations
    DURATION_BOUNDS = (0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
                       10.0, 30.0, 60.0)

    __slots__ = ("bounds", "_counts", "_sum", "_n", "_lock")

    def __init__(self, bounds=LATENCY_BOUNDS):
        self.bounds = tuple(bounds)
        if list(self.bounds) != sorted(self.bounds) or not self.bounds:
            raise ValueError("histogram bounds must be sorted, non-empty")
        self._counts = [0] * (len(self.bounds) + 1)   # +1 = +Inf overflow
        self._sum = 0.0
        self._n = 0
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        i = 0
        for i, b in enumerate(self.bounds):
            if v <= b:
                break
        else:
            i = len(self.bounds)
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._n += 1

    @property
    def count(self) -> int:
        return self._n

    @property
    def sum(self) -> float:
        return self._sum

    def buckets(self) -> list[tuple[float, int]]:
        """(upper_bound, CUMULATIVE count) per bucket, +Inf last — the
        exposition-format shape."""
        with self._lock:
            counts = list(self._counts)
        out, cum = [], 0
        for b, c in zip(self.bounds, counts):
            cum += c
            out.append((b, cum))
        out.append((float("inf"), cum + counts[-1]))
        return out

    def quantile(self, q: float) -> float:
        """Estimated q-quantile (0 < q <= 1).  0.0 when empty; values in
        the overflow bucket report the highest finite bound (the same
        saturation Prometheus' histogram_quantile applies)."""
        with self._lock:
            counts = list(self._counts)
            n = self._n
        if n == 0:
            return 0.0
        target = q * n
        cum = 0
        lo = 0.0
        for b, c in zip(self.bounds, counts):
            if cum + c >= target and c > 0:
                return lo + (b - lo) * (target - cum) / c
            cum += c
            lo = b
        return self.bounds[-1]

    def snapshot(self) -> dict:
        return {"count": self.count, "sum": round(self._sum, 6),
                "p50": round(self.quantile(0.50), 6),
                "p90": round(self.quantile(0.90), 6),
                "p99": round(self.quantile(0.99), 6)}


class CounterVec:
    """A counter family keyed by one label (e.g. the crypto ladder rung):
    `vec.labels("cuda").inc()`.  Cells are created on first touch so a
    scrape sees exactly the rungs that have served calls — a demotion to
    `native` appears as a new labeled series the moment it happens."""

    __slots__ = ("label", "_cells", "_lock")

    def __init__(self, label: str):
        self.label = label
        self._cells: dict[str, Counter] = {}
        self._lock = threading.Lock()

    def labels(self, value: str) -> Counter:
        with self._lock:
            c = self._cells.get(value)
            if c is None:
                c = self._cells[value] = Counter()
            return c

    def items(self) -> list[tuple[str, int]]:
        with self._lock:
            return [(k, c.value) for k, c in sorted(self._cells.items())]


class GaugeVec:
    """A gauge family keyed by one label — per-device utilization gauges
    (`vec.labels("cuda:0").set(0.92)`) without pre-declaring the device
    list."""

    __slots__ = ("label", "_cells", "_lock")

    def __init__(self, label: str):
        self.label = label
        self._cells: dict[str, Gauge] = {}
        self._lock = threading.Lock()

    def labels(self, value: str) -> Gauge:
        with self._lock:
            g = self._cells.get(value)
            if g is None:
                g = self._cells[value] = Gauge()
            return g

    def items(self) -> list[tuple[str, float]]:
        with self._lock:
            return [(k, g.value) for k, g in sorted(self._cells.items())]


class HistogramVec:
    """A histogram family keyed by one label — per-class batch-plane
    queue-wait distributions (`vec.labels("consensus").observe(dt)`)
    without pre-declaring the class list.  Renders as one labeled
    _bucket/_sum/_count triple per cell."""

    __slots__ = ("label", "bounds", "_cells", "_lock")

    def __init__(self, label: str, bounds=Histogram.LATENCY_BOUNDS):
        self.label = label
        self.bounds = tuple(bounds)
        self._cells: dict[str, Histogram] = {}
        self._lock = threading.Lock()

    def labels(self, value: str) -> Histogram:
        with self._lock:
            h = self._cells.get(value)
            if h is None:
                h = self._cells[value] = Histogram(self.bounds)
            return h

    def items(self) -> list[tuple[str, Histogram]]:
        with self._lock:
            return sorted(self._cells.items())

    def snapshot(self) -> dict:
        return {k: h.snapshot() for k, h in self.items()}


class Registry:
    def __init__(self):
        self._start = time.time()
        # consensus plane
        self.blocks_committed = Counter()
        self.txs_committed = Counter()
        self.rounds_started = Counter()
        # crypto plane
        self.sigs_verified = Counter()        # signatures that PASSED
        self.sigs_requested = Counter()       # real signatures asked for
        self.verify_batches = Counter()
        self.batch_occupancy = Summary()      # real/padded per batch
        self.device_step_seconds = Summary()  # wait-for-result per call
        self.device_dispatch_seconds = Summary()  # dispatch->result wall
        #   (includes overlapped host work in pipelined callers)
        self.table_build_seconds = Summary()  # comb-table builds (per set)
        # tail-aware distributions (the Summary twins above keep the
        # steering heuristics; these feed the /metrics scrape + p99s)
        self.device_step_hist = Histogram(Histogram.LATENCY_BOUNDS)
        self.batch_occupancy_hist = Histogram(Histogram.RATIO_BOUNDS)
        self.round_seconds_hist = Histogram(Histogram.DURATION_BOUNDS)
        # supervised-crypto plane (crypto/supervised.py)
        self.crypto_device_faults = Counter()   # faults seen on any rung
        self.crypto_fallback_calls = Counter()  # calls served below rung 0
        self.crypto_breaker_trips = Counter()   # CLOSED/HALF-OPEN -> OPEN
        self.crypto_breaker_recoveries = Counter()  # HALF-OPEN -> CLOSED
        self.crypto_spot_checks = Counter()
        self.crypto_spot_check_mismatches = Counter()
        # per-rung call/fault counts, labeled by ladder rung
        # (cuda/native/python): a SupervisedBackend demotion shows up on a
        # scrape as the lower rung's calls series starting to move
        self.crypto_rung_calls = CounterVec("rung")
        self.crypto_rung_faults = CounterVec("rung")
        # live-vote micro-batching (receive-loop burst ingestion)
        self.vote_microbatches = Counter()
        self.vote_microbatch_lanes = Counter()
        # sync plane
        self.blocks_synced = Counter()
        # state-sync / snapshot plane (statesync/): chunks_verified vs
        # chunks_rejected is the no-silent-acceptance ledger — every
        # fetched chunk lands in exactly one of the two, and a rejected
        # chunk always carries a peer blame on the switch
        self.snapshots_created = Counter()
        self.snapshot_create_seconds = Summary()
        self.snapshot_restore_seconds = Summary()
        self.chunks_verified = Counter()
        self.chunks_rejected = Counter()
        self.restore_replay_blocks = Counter()  # snapshot_height -> tip
        # p2p plane
        self.peers = Gauge()
        self.msgs_sent = Counter()
        self.msgs_received = Counter()
        # p2p self-healing plane (p2p/switch.py): reconnect attempts are
        # the graceful-degradation signal under partitions (a heal storm
        # shows as a burst, a dead peer as a bounded trickle); evictions
        # count misbehavior-score bans, never plain connection deaths
        self.switch_reconnect_attempts = Counter()
        self.switch_peers_evicted = Counter()
        # kernel build/first-launch plane (ops/kernels.py, crypto/
        # backend.py), under the JAX series names: a new shape on a warm
        # entry means the bucketing in crypto/backend._bucket() leaked a
        # new padded shape
        self.xla_compiles = Counter()           # kernel library builds+loads
        self.xla_compile_seconds = Summary()    # per build+load duration
        self.xla_first_call_seconds = Summary()  # first launch per kernel
        self.xla_cache_hits = Counter()         # launch on a seen shape
        self.xla_cache_misses = Counter()       # launch on a new shape
        self.xla_recompiles = Counter()         # new shape on a warm entry
        # host<->device transfer plane
        self.h2d_bytes = Counter()
        self.d2h_bytes = Counter()
        # per-device plane (parallel/sharding.py multi-device runs)
        self.device_util = GaugeVec("device")    # busy fraction per device
        self.device_lanes = CounterVec("device")  # lanes served per device
        # pipeline attribution plane (utils/attribution.py per-window
        # partition of replay wall clock)
        self.window_overlap_frac_hist = Histogram(Histogram.RATIO_BOUNDS)
        self.window_device_busy_frac_hist = Histogram(
            Histogram.RATIO_BOUNDS)
        self.window_device_idle_frac_hist = Histogram(
            Histogram.RATIO_BOUNDS)
        self.window_scalar_seconds = Histogram(Histogram.DURATION_BOUNDS)
        # bench regression ledger (utils/ledger.py): worst per-config
        # delta_frac of the latest run vs best prior (negative = slower);
        # alert on < -threshold
        self.bench_regression = Gauge()
        # unified batch plane (batchplane/scheduler.py): the coalescing
        # proof lives here — occupancy is real lanes over the padded
        # chunk a flush rode, mixed_batches counts flushes whose lanes
        # came from >1 producer, and the per-class wait histogram is
        # the latency cost each class paid to coalesce
        self.batchplane_flushes = Counter()
        self.batchplane_mixed_batches = Counter()
        self.batchplane_flush_reason = CounterVec("reason")
        self.batchplane_lanes = CounterVec("producer")
        self.batchplane_occupancy_hist = Histogram(Histogram.RATIO_BOUNDS)
        self.batchplane_queue_depth_hist = Histogram(
            (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024))
        self.batchplane_wait_seconds = HistogramVec(
            "klass", Histogram.LATENCY_BOUNDS)
        # mempool ingress plane (mempool/mempool.py admission
        # controller): every submission lands in exactly one outcome —
        # admitted into the pool or counted in rejected{reason} — and
        # every eviction in evicted{reason}; that accounting identity
        # is the zero-silent-drops invariant the eviction-storm
        # scenario audits.  admit_seconds is the per-submission
        # admission latency (dup/full rejects included) whose p50/p99
        # the mempool-flood gate budgets.
        self.mempool_size = Gauge()
        self.mempool_bytes = Gauge()
        self.mempool_rejected = CounterVec("reason")
        self.mempool_evicted = CounterVec("reason")
        self.mempool_admit_seconds = Histogram(Histogram.LATENCY_BOUNDS)
        # consensus timeline plane (telemetry/): per-stage height
        # lifecycle durations (propose / prevote / precommit / commit —
        # the four stages partition each height's wall clock, same
        # sums-to-wall invariant as utils/attribution.py), gossip
        # fan-out lag (origin send-stamp -> ingest at the receiver),
        # batchplane verify wait attributable to vote ingest, and a
        # per-node last-committed-height gauge fed by the mesh
        # collector (node ids are hostname-shaped: dashes/dots).
        self.consensus_stage_seconds = HistogramVec(
            "stage", Histogram.DURATION_BOUNDS)
        self.consensus_height_seconds = Histogram(
            Histogram.DURATION_BOUNDS)
        self.gossip_fanout_seconds = Histogram(Histogram.LATENCY_BOUNDS)
        self.timeline_node_height = GaugeVec("node")

    def snapshot(self) -> dict:
        up = max(time.time() - self._start, 1e-9)
        return {
            "uptime_seconds": round(up, 1),
            "blocks_committed": self.blocks_committed.value,
            "blocks_per_sec": round(self.blocks_committed.value / up, 3),
            "txs_committed": self.txs_committed.value,
            "rounds_started": self.rounds_started.value,
            "sigs_requested": self.sigs_requested.value,
            "sigs_verified": self.sigs_verified.value,
            "sigs_per_sec": round(self.sigs_requested.value / up, 1),
            "verify_batches": self.verify_batches.value,
            "batch_occupancy_mean": round(self.batch_occupancy.mean, 4),
            "device_step_seconds_mean":
                round(self.device_step_seconds.mean, 6),
            "device_dispatch_seconds_mean":
                round(self.device_dispatch_seconds.mean, 6),
            "crypto_device_faults": self.crypto_device_faults.value,
            "crypto_fallback_calls": self.crypto_fallback_calls.value,
            "crypto_breaker_trips": self.crypto_breaker_trips.value,
            "crypto_breaker_recoveries":
                self.crypto_breaker_recoveries.value,
            "crypto_spot_checks": self.crypto_spot_checks.value,
            "crypto_spot_check_mismatches":
                self.crypto_spot_check_mismatches.value,
            "vote_microbatches": self.vote_microbatches.value,
            "vote_microbatch_lanes": self.vote_microbatch_lanes.value,
            "blocks_synced": self.blocks_synced.value,
            "snapshots_created": self.snapshots_created.value,
            "snapshot_create_seconds_mean":
                round(self.snapshot_create_seconds.mean, 6),
            "snapshot_restore_seconds_mean":
                round(self.snapshot_restore_seconds.mean, 6),
            "chunks_verified": self.chunks_verified.value,
            "chunks_rejected": self.chunks_rejected.value,
            "restore_replay_blocks": self.restore_replay_blocks.value,
            "peers": self.peers.value,
            "p2p_msgs_sent": self.msgs_sent.value,
            "p2p_msgs_received": self.msgs_received.value,
            "switch_reconnect_attempts":
                self.switch_reconnect_attempts.value,
            "switch_peers_evicted": self.switch_peers_evicted.value,
            "device_step_seconds": self.device_step_hist.snapshot(),
            "batch_occupancy": self.batch_occupancy_hist.snapshot(),
            "round_seconds": self.round_seconds_hist.snapshot(),
            "crypto_rung_calls": dict(self.crypto_rung_calls.items()),
            "crypto_rung_faults": dict(self.crypto_rung_faults.items()),
            "xla_compiles": self.xla_compiles.value,
            "xla_compile_seconds_mean":
                round(self.xla_compile_seconds.mean, 3),
            "xla_cache_hits": self.xla_cache_hits.value,
            "xla_cache_misses": self.xla_cache_misses.value,
            "xla_recompiles": self.xla_recompiles.value,
            "h2d_bytes": self.h2d_bytes.value,
            "d2h_bytes": self.d2h_bytes.value,
            "device_util": dict(self.device_util.items()),
            "bench_regression": self.bench_regression.value,
            "batchplane_flushes": self.batchplane_flushes.value,
            "batchplane_mixed_batches":
                self.batchplane_mixed_batches.value,
            "batchplane_flush_reason":
                dict(self.batchplane_flush_reason.items()),
            "batchplane_lanes": dict(self.batchplane_lanes.items()),
            "batchplane_occupancy":
                self.batchplane_occupancy_hist.snapshot(),
            "batchplane_queue_depth":
                self.batchplane_queue_depth_hist.snapshot(),
            "batchplane_wait_seconds":
                self.batchplane_wait_seconds.snapshot(),
            "mempool_size": self.mempool_size.value,
            "mempool_bytes": self.mempool_bytes.value,
            "mempool_rejected": dict(self.mempool_rejected.items()),
            "mempool_evicted": dict(self.mempool_evicted.items()),
            "mempool_admit_seconds":
                self.mempool_admit_seconds.snapshot(),
            "consensus_stage_seconds":
                self.consensus_stage_seconds.snapshot(),
            "consensus_height_seconds":
                self.consensus_height_seconds.snapshot(),
            "gossip_fanout_seconds":
                self.gossip_fanout_seconds.snapshot(),
            "timeline_node_height": dict(self.timeline_node_height.items()),
        }


REGISTRY = Registry()


def snapshot() -> dict:
    return REGISTRY.snapshot()


# -- Prometheus text exposition (format version 0.0.4) ----------------------

_PROM_PREFIX = "tendermint_"

# wall-clock process start, exported as the standard (unprefixed)
# `process_start_time_seconds` so Prometheus' `time() - ...` uptime
# recipes and restart detection work against this exporter
_PROCESS_START = time.time()

# build_info labels, populated by set_build_info() as subsystems learn
# facts about themselves (the node fills in its crypto backend and the
# card's name); rendered as the conventional value-1 info gauge
_BUILD_INFO: dict[str, str] = {}
_BUILD_INFO_LOCK = threading.Lock()


def set_build_info(**labels) -> None:
    """Merge label->value pairs into the build_info gauge (values are
    stringified; None values are skipped)."""
    with _BUILD_INFO_LOCK:
        for k, v in labels.items():
            if v is not None:
                _BUILD_INFO[k] = str(v)


set_build_info(version=__version__)


def _prom_f(v: float) -> str:
    """Prometheus float rendering: +Inf spelled out, no exponent noise."""
    if v == float("inf"):
        return "+Inf"
    return repr(float(v)) if isinstance(v, float) else str(v)


def _prom_escape(v: str) -> str:
    """Label-VALUE escaping per the 0.0.4 text format: backslash, double
    quote and line feed must be escaped inside the quotes — an unescaped
    newline in a label value splits the line and corrupts the whole
    scrape."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def prometheus_text(registry: Registry | None = None) -> str:
    """The whole registry in the Prometheus text exposition format,
    served at GET /metrics by the RPC server.  Instruments map by type:
    Counter -> counter, Gauge/Summary -> gauge(s), Histogram -> the
    _bucket{le=}/_sum/_count triple, CounterVec -> one labeled series
    per cell."""
    r = registry if registry is not None else REGISTRY
    lines: list[str] = []
    for attr, inst in vars(r).items():
        if attr.startswith("_"):
            continue
        name = _PROM_PREFIX + attr
        if isinstance(inst, Counter):
            lines += [f"# TYPE {name} counter", f"{name} {inst.value}"]
        elif isinstance(inst, Gauge):
            lines += [f"# TYPE {name} gauge", f"{name} {_prom_f(inst.value)}"]
        elif isinstance(inst, Summary):
            lines.append(f"# TYPE {name} gauge")
            lines.append(f"{name}{{stat=\"mean\"}} {_prom_f(inst.mean)}")
            lines.append(f"{name}{{stat=\"min\"}} {_prom_f(inst.min)}")
            lines.append(f"{name}_count {inst.count}")
        elif isinstance(inst, Histogram):
            lines.append(f"# TYPE {name} histogram")
            for le, cum in inst.buckets():
                lines.append(f"{name}_bucket{{le=\"{_prom_f(le)}\"}} {cum}")
            lines.append(f"{name}_sum {_prom_f(inst.sum)}")
            lines.append(f"{name}_count {inst.count}")
        elif isinstance(inst, CounterVec):
            lines.append(f"# TYPE {name} counter")
            for label_value, v in inst.items():
                lines.append(
                    f"{name}{{{inst.label}=\"{_prom_escape(label_value)}\"}}"
                    f" {v}")
        elif isinstance(inst, GaugeVec):
            lines.append(f"# TYPE {name} gauge")
            for label_value, v in inst.items():
                lines.append(
                    f"{name}{{{inst.label}=\"{_prom_escape(label_value)}\"}}"
                    f" {_prom_f(v)}")
        elif isinstance(inst, HistogramVec):
            lines.append(f"# TYPE {name} histogram")
            for label_value, h in inst.items():
                lv = _prom_escape(label_value)
                for le, cum in h.buckets():
                    lines.append(
                        f"{name}_bucket{{{inst.label}=\"{lv}\","
                        f"le=\"{_prom_f(le)}\"}} {cum}")
                lines.append(
                    f"{name}_sum{{{inst.label}=\"{lv}\"}} "
                    f"{_prom_f(h.sum)}")
                lines.append(
                    f"{name}_count{{{inst.label}=\"{lv}\"}} {h.count}")
    lines.append(f"# TYPE {_PROM_PREFIX}uptime_seconds gauge")
    lines.append(f"{_PROM_PREFIX}uptime_seconds "
                 f"{_prom_f(round(time.time() - r._start, 3))}")
    # standard process metric (unprefixed by convention): lets the usual
    # restart-detection and uptime recording rules work unmodified
    lines.append("# TYPE process_start_time_seconds gauge")
    lines.append(f"process_start_time_seconds {_prom_f(_PROCESS_START)}")
    with _BUILD_INFO_LOCK:
        info = dict(_BUILD_INFO)
    labels = ",".join(f'{k}="{_prom_escape(v)}"'
                      for k, v in sorted(info.items()))
    lines.append(f"# TYPE {_PROM_PREFIX}build_info gauge")
    lines.append(f"{_PROM_PREFIX}build_info{{{labels}}} 1")
    return "\n".join(lines) + "\n"
