"""The port's metrics registry, leveled logger and bench ledger held
against the JAX package's (`tendermint_tpu/utils/{metrics,log,ledger}.py`)
with zero tolerance: the same sequence of instrument updates, made from a
numpy seed, gives the same `snapshot()` and the same Prometheus text
(uptime and build info aside); the same records print the same log lines
under a fixed clock; the same ledger gives the same deltas and history,
and each package reads the other's ledger file."""

import json

import numpy as np
import pytest

from tendermint_tpu.utils import ledger as jledger
from tendermint_tpu.utils import log as jlog
from tendermint_tpu.utils import metrics as jmetrics
from tendermint_tpu_torch.utils import ledger, log, metrics

SEEDS = (0, 1, 2, 3, 4)
# uptime-dependent keys of `snapshot()`
_UPTIME_KEYS = ("uptime_seconds", "blocks_per_sec", "sigs_per_sec")
# lines of `prometheus_text()` that carry the clock or the build
_CLOCK_SERIES = ("tendermint_uptime_seconds", "process_start_time_seconds",
                 "tendermint_build_info")
LABELS = ("cuda", "native", "python", "consensus", "mempool", "a\"b\\c\nd")


def _drive(reg, mod, rng) -> None:
    """One seeded sequence of updates over every instrument of `reg`, in
    its attribute order, with values drawn from `rng`."""
    for attr, inst in vars(reg).items():
        if attr.startswith("_"):
            continue
        for _ in range(int(rng.integers(0, 6))):
            v = float(rng.choice([rng.random(), rng.random() * 20.0,
                                  float(rng.integers(0, 5000))]))
            lab = LABELS[int(rng.integers(0, len(LABELS)))]
            if isinstance(inst, mod.Counter):
                inst.inc(int(rng.integers(1, 1000)))
            elif isinstance(inst, mod.Gauge):
                inst.set(v)
            elif isinstance(inst, (mod.Summary, mod.Histogram)):
                inst.observe(v)
            elif isinstance(inst, mod.CounterVec):
                inst.labels(lab).inc(int(rng.integers(1, 50)))
            elif isinstance(inst, mod.GaugeVec):
                inst.labels(lab).set(v)
            elif isinstance(inst, mod.HistogramVec):
                inst.labels(lab).observe(v)
            else:
                raise AssertionError(f"unknown instrument {attr}")


def _prom(text: str) -> list:
    return [ln for ln in text.splitlines()
            if not any(s in ln for s in _CLOCK_SERIES)]


@pytest.mark.parametrize("seed", SEEDS)
def test_same_updates_give_the_same_snapshot_and_scrape(seed):
    reg, jreg = metrics.Registry(), jmetrics.Registry()
    _drive(reg, metrics, np.random.default_rng(seed))
    _drive(jreg, jmetrics, np.random.default_rng(seed))
    got, want = reg.snapshot(), jreg.snapshot()
    for k in _UPTIME_KEYS:
        got.pop(k), want.pop(k)
    assert got == want
    assert _prom(metrics.prometheus_text(reg)) == \
        _prom(jmetrics.prometheus_text(jreg))


def test_series_names_and_instrument_types_match_jax():
    """Every JAX series, under its name and type, and no other; the
    process registry's build info carries the port's version."""
    reg, jreg = metrics.Registry(), jmetrics.Registry()
    assert [(a, type(i).__name__) for a, i in vars(reg).items()] == \
        [(a, type(i).__name__) for a, i in vars(jreg).items()]
    types = [ln for ln in metrics.prometheus_text(reg).splitlines()
             if ln.startswith("# TYPE")]
    jtypes = [ln for ln in jmetrics.prometheus_text(jreg).splitlines()
              if ln.startswith("# TYPE")]
    assert types == jtypes
    from tendermint_tpu_torch import __version__
    assert f'version="{__version__}"' in metrics.prometheus_text(reg)


@pytest.mark.parametrize("q", (0.0001, 0.5, 0.9, 0.99, 1.0))
def test_histogram_quantiles_and_buckets_match_jax(q):
    rng = np.random.default_rng(7)
    vals = np.concatenate([rng.exponential(0.01, 300),
                           rng.exponential(2.0, 40), [0.0, 50.0]])
    for bounds in (metrics.Histogram.LATENCY_BOUNDS,
                   metrics.Histogram.RATIO_BOUNDS,
                   metrics.Histogram.DURATION_BOUNDS):
        h, jh = metrics.Histogram(bounds), jmetrics.Histogram(bounds)
        for v in vals:
            h.observe(float(v))
            jh.observe(float(v))
        assert h.quantile(q) == jh.quantile(q)
        assert h.buckets() == jh.buckets()
        assert h.snapshot() == jh.snapshot()


@pytest.mark.parametrize("alpha", (0.1, 0.5, 1.0))
def test_summary_and_vecs_match_jax(alpha):
    rng = np.random.default_rng(int(alpha * 10))
    sm, jsm = metrics.Summary(alpha), jmetrics.Summary(alpha)
    for v in rng.exponential(1.0, 50):
        sm.observe(float(v))
        jsm.observe(float(v))
        assert (sm.mean, sm.min, sm.count) == (jsm.mean, jsm.min, jsm.count)
    hv, jhv = (metrics.HistogramVec("klass", metrics.Histogram.RATIO_BOUNDS),
               jmetrics.HistogramVec("klass",
                                     jmetrics.Histogram.RATIO_BOUNDS))
    for lab, v in zip(rng.choice(LABELS, 40), rng.random(40)):
        hv.labels(str(lab)).observe(float(v))
        jhv.labels(str(lab)).observe(float(v))
    assert hv.snapshot() == jhv.snapshot()


def test_ledger_rate_of_and_best_prior_match_jax():
    es = _entries(5)
    for e in es:
        for cfg, res in e["configs"].items():
            assert ledger.rate_of(cfg, res) == jledger.rate_of(cfg, res)
    assert ledger.best_prior(es) == jledger.best_prior(es)


def test_histogram_refuses_unsorted_bounds_as_jax_does():
    for mod in (metrics, jmetrics):
        with pytest.raises(ValueError, match="sorted"):
            mod.Histogram((1.0, 0.5))


# -- the leveled logger --------------------------------------------------------

class _FixedClock:
    """`time` with a fixed epoch and local time."""

    def __init__(self, t: float):
        self.t = t

    def time(self):
        return self.t

    def localtime(self, t):
        import time
        return time.gmtime(t)

    def strftime(self, fmt, tm):
        import time
        return time.strftime(fmt, tm)


RECORDS = [
    ("consensus", "info", "committed block",
     {"height": 7, "hash": bytes(range(32)), "txs": 3}),
    ("p2p", "warn", "dial failed", {"addr": "127.0.0.1:26656",
                                     "err": "connection refused"}),
    ("blockchain", "debug", "synced window",
     {"verify_seconds": 0.012345678, "sigs": 6400}),
    ("crypto", "error", "crypto breaker tripped",
     {"rung": "cuda", "fault": "a=b", "consecutive": 2}),
    ("statesync", "info", "snapshot restored", {"seconds": 1234.5678}),
    ("a-very-long-module-name", "info", "x", {}),
]


@pytest.mark.parametrize("spec", ["", "debug", "*:error", "consensus:debug,"
                                  "p2p:error,*:info", "none"])
def test_log_lines_equal_under_a_fixed_clock(monkeypatch, spec):
    got, want = [], []
    for mod, sink in ((log, got), (jlog, want)):
        monkeypatch.setattr(mod, "time", _FixedClock(1_700_000_123.4567))
        mod.set_sink(sink.append)
        mod.set_level_spec(spec)
    try:
        for module, level, msg, kv in RECORDS:
            for mod in (log, jlog):
                lg = mod.get_logger(module)
                getattr(lg, level)(msg, **kv)
                getattr(lg.with_(node="n0", h=b"\x01\x02"), level)(msg,
                                                                   **kv)
    finally:
        for mod in (log, jlog):
            mod.set_sink(None)
            mod.set_level_spec("info")
    assert got == want
    assert (len(got) > 0) == (spec != "none")


def test_log_exception_and_bad_spec_as_jax():
    got, want = [], []
    for mod, sink in ((log, got), (jlog, want)):
        mod.set_sink(sink.append)
    try:
        for mod in (log, jlog):
            try:
                raise ValueError("boom")
            except ValueError:
                mod.get_logger("replay").exception("error replaying")
            with pytest.raises(ValueError, match="unknown log level"):
                mod.set_level_spec("consensus:loud")
    finally:
        for mod in (log, jlog):
            mod.set_sink(None)
            mod.set_level_spec("info")
    assert [ln.split(" ", 1)[1] for ln in got] == \
        [ln.split(" ", 1)[1] for ln in want]


# -- the bench ledger ----------------------------------------------------------

def _entries(seed: int) -> list:
    rng = np.random.default_rng(seed)
    out = []
    for i in range(6):
        configs = {}
        for cfg in ("config0", "config1", "config2", "config3", "config4",
                    "custom"):
            if rng.random() < 0.2:
                configs[cfg] = {"error": "timed out"}
                continue
            key = jledger.RATE_KEYS.get(cfg, "ops_per_sec")
            configs[cfg] = {key: float(rng.random() * 10_000),
                            "seconds": float(rng.random())}
        out.append({"schema": jledger.LEDGER_SCHEMA,
                    "timestamp": f"2026-10-{i + 1:02d}T00:00:00Z",
                    "quick": bool(rng.random() < 0.5), "configs": configs})
    return out


@pytest.mark.parametrize("seed", SEEDS)
def test_ledger_deltas_and_history_match_jax(seed):
    es = _entries(seed)
    for thr in (0.0, 0.15, 0.5):
        assert ledger.compute_deltas(es[:-1], es[-1]["configs"], thr) == \
            jledger.compute_deltas(es[:-1], es[-1]["configs"], thr)
    assert ledger.render_history(es) == jledger.render_history(es)
    assert ledger.render_history([]) == jledger.render_history([])


def test_ledger_files_cross_between_the_packages(tmp_path):
    """Lines appended by one package are read by the other unchanged; a
    torn last line is skipped by both."""
    es = _entries(11)
    jpath, path = tmp_path / "j.jsonl", tmp_path / "p.jsonl"
    for i, e in enumerate(es):
        (jledger if i % 2 else ledger).append_entry(str(jpath), e)
        (ledger if i % 2 else jledger).append_entry(str(path), e)
    assert jpath.read_bytes() == path.read_bytes()
    with open(path, "a") as f:
        f.write(json.dumps(es[0])[:17])
    assert ledger.load(str(path)) == jledger.load(str(path)) == es
    assert ledger.load(str(tmp_path / "missing")) == []
