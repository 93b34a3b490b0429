"""The port's flight recorder and attribution doctor held against the JAX
package's (`tendermint_tpu/utils/{tracing,attribution}.py`) with zero
tolerance: the same span dicts, made from a numpy seed, give the same
`window_attribution`, `overlap_summary`, `doctor_report` and rendered
report; a recorder dump of either package is read by the other's
`spans_from_chrome` unchanged; the recorders record, overwrite and dump
alike.  Also the port's own parts: the `kernel.` category, the spans of
`CudaBackend(device="cpu")` and the replay loops, and the
`torch.profiler` device trace started and stopped from different
threads."""

import json
import os
import threading

import numpy as np
import pytest
import torch

from tendermint_tpu.utils import attribution as jattribution
from tendermint_tpu.utils import tracing as jtracing
from tendermint_tpu_torch.utils import attribution, trace, tracing
from tendermint_tpu_torch.utils.metrics import REGISTRY

from torch_chains import share_cores


@pytest.fixture(autouse=True, scope="module")
def _share_cores():
    """xdist runs several files at once: this worker's share of the cores
    for torch (several torch pools on the same cores run ~20x slower)."""
    n = share_cores()
    yield
    torch.set_num_threads(n)

SEEDS = (0, 1, 2, 3, 4, 5)
NAMES = ("fastsync.prepare", "fastsync.verify", "fastsync.apply",
         "verify.dispatch", "verify.collect", "transfer.h2d",
         "xla.firstcall", "scalar.verify", "bench.prep", "bench.apply",
         "wal.write", "consensus.stage.propose", "unknown.span")


def _spans(seed: int) -> list:
    """Seeded span dicts in the recorder's snapshot form: overlapping
    windows keyed by `window`, uncategorized and explicit-category
    spans, instants and zero-length spans."""
    rng = np.random.default_rng(seed)
    out = []
    t = 1_700_000_000.0
    for w in range(int(rng.integers(0, 6))):
        for _ in range(int(rng.integers(1, 8))):
            name = NAMES[int(rng.integers(0, len(NAMES)))]
            s = {"name": name, "ph": "X",
                 "ts": t + float(rng.random() * 2.0),
                 "dur": float(rng.choice([0.0, rng.random()])),
                 "tid": 1, "thread": "main", "lane": "main"}
            args = {"blocks": int(rng.integers(1, 100))}
            if rng.random() < 0.7:
                args["window"] = w
            s["args"] = args
            if rng.random() < 0.2:
                s["cat"] = ["device", "prep", "apply", "compile",
                            ""][int(rng.integers(0, 5))] or None
                if s["cat"] is None:
                    del s["cat"]
            out.append(s)
        t += float(rng.random() * 1.5)
    for _ in range(int(rng.integers(0, 3))):
        out.append({"name": "pool.evict", "ph": "i",
                    "ts": t + float(rng.random()), "dur": 0.0, "tid": 1,
                    "thread": "main", "lane": "main",
                    "args": {"peer": "ab"}})
    if rng.random() < 0.3:                 # no window key anywhere
        for s in out:
            s.get("args", {}).pop("window", None)
    return out


def _metrics(seed: int):
    rng = np.random.default_rng(seed + 100)
    if rng.random() < 0.3:
        return None
    n = int(rng.integers(0, 20))
    return {"batchplane_flushes": n,
            "batchplane_mixed_batches": int(rng.integers(0, n + 1)),
            "batchplane_occupancy": {"count": n,
                                     "sum": float(rng.random() * n),
                                     "p50": 0.5},
            "batchplane_flush_reason": {"full": 1, "deadline": n},
            "batchplane_lanes": {"mempool": 3 * n},
            "batchplane_wait_seconds": {}}


@pytest.mark.parametrize("seed", SEEDS)
def test_attribution_matches_jax_on_the_same_spans(seed):
    spans, metrics_ = _spans(seed), _metrics(seed)
    rows = attribution.window_attribution(spans)
    assert rows == jattribution.window_attribution(spans)
    assert attribution.overlap_summary(rows) == \
        jattribution.overlap_summary(rows)
    regs = {"config3": {"rate": 5.0, "unit": "sigs_per_sec",
                        "best_prior": 9.0, "delta_frac": -0.44,
                        "regression": True}} if seed % 2 else None
    rep = attribution.doctor_report(spans, regressions=regs,
                                    metrics=metrics_)
    assert rep == jattribution.doctor_report(spans, regressions=regs,
                                             metrics=metrics_)
    assert attribution.render_report(rep) == jattribution.render_report(rep)
    for r in rows:            # the partition sums to each window's wall
        parts = sum(r[k] for k in ("compile", "transfer", "device_busy",
                                   "scalar_tail", "device_idle"))
        assert parts == pytest.approx(r["wall"], rel=1e-12, abs=1e-12)


@pytest.mark.parametrize("seed", SEEDS)
def test_attribution_parts_match_jax(seed, monkeypatch):
    """The doctor's parts on the same spans: category intervals, window
    groups, one interval's partition, the batch plane's summary, and the
    `window_*` histograms a window feeds."""
    from tendermint_tpu.utils import metrics as jmetrics
    from tendermint_tpu_torch.utils import metrics
    spans = _spans(seed)
    cats = attribution.spans_by_category(spans)
    assert cats == jattribution.spans_by_category(spans)
    wins = attribution.find_windows(spans)
    assert wins == jattribution.find_windows(spans)
    for lo, hi in list(wins.values())[:3]:
        assert attribution.attribute_interval(cats, lo, hi) == \
            jattribution.attribute_interval(cats, lo, hi)
    m = _metrics(seed) or {}
    assert attribution.batchplane_summary(m) == \
        jattribution.batchplane_summary(m)
    reg, jreg = metrics.Registry(), jmetrics.Registry()
    monkeypatch.setattr(metrics, "REGISTRY", reg)
    monkeypatch.setattr(jmetrics, "REGISTRY", jreg)
    for r in attribution.window_attribution(spans):
        attribution.observe_window_metrics(r)
        jattribution.observe_window_metrics(r)
    keys = [k for k in reg.snapshot() if k.startswith("window_")]
    assert [reg.snapshot()[k] for k in keys] == \
        [jreg.snapshot()[k] for k in keys]
    for attr in ("window_overlap_frac_hist", "window_device_busy_frac_hist",
                 "window_device_idle_frac_hist", "window_scalar_seconds"):
        assert getattr(reg, attr).buckets() == getattr(jreg, attr).buckets()


@pytest.mark.parametrize("seed", SEEDS[:3])
def test_interval_arithmetic_matches_jax(seed):
    rng = np.random.default_rng(seed)
    ivs = [sorted(rng.random(2) * 10) for _ in range(12)]
    ivs = [(float(a), float(b)) for a, b in ivs]
    a, b = attribution.merge(ivs[:6]), attribution.merge(ivs[6:])
    assert a == jattribution.merge(ivs[:6])
    assert attribution.subtract(a, b) == jattribution.subtract(a, b)
    assert attribution.intersect(a, b) == jattribution.intersect(a, b)
    assert attribution.clip(ivs, 2.0, 7.5) == \
        jattribution.clip(ivs, 2.0, 7.5)
    for k in (1, 2, 3):
        assert attribution.covered_by_at_least([a, b], k) == \
            jattribution.covered_by_at_least([a, b], k)


def _record(rec, mod, seed):
    rng = np.random.default_rng(seed)
    for i in range(40):
        name = NAMES[int(rng.integers(0, len(NAMES)))]
        ts = 1_700_000_000.0 + i * 0.01
        if rng.random() < 0.2:
            rec.record(name, ts, 0.0, {"i": i}, ph=mod.PH_INSTANT)
        else:
            rec.record(name, ts, float(rng.random() * 0.02),
                       {"window": i // 7} if rng.random() < 0.8 else None,
                       cat=(mod.CAT_NONE if rng.random() < 0.1 else None),
                       lane="lane%d" % (i % 3) if i % 4 == 0 else None)


@pytest.mark.parametrize("cap", (8, 64))
def test_recorders_record_overwrite_and_dump_alike(cap):
    rec, jrec = tracing.FlightRecorder(cap), jtracing.FlightRecorder(cap)
    _record(rec, tracing, 3)
    _record(jrec, jtracing, 3)
    assert rec.snapshot() == jrec.snapshot()
    assert (rec.total, rec.dropped) == (jrec.total, jrec.dropped)
    assert rec.to_chrome_trace() == jrec.to_chrome_trace()
    assert rec.last("fastsync.apply") == jrec.last("fastsync.apply")
    assert rec.recent(5) == rec.snapshot()[-5:]
    assert rec.recent(10 * cap) == rec.snapshot()
    rec.clear()
    assert rec.snapshot() == [] and rec.recent(3) == []
    with pytest.raises(ValueError):
        tracing.FlightRecorder(0)


def test_recorder_dumps_cross_between_the_packages(tmp_path):
    """`spans_from_chrome` of a JAX recorder dump equals the port's, and
    the reverse; both doctors read either dump to the same report."""
    rec, jrec = tracing.FlightRecorder(256), jtracing.FlightRecorder(256)
    _record(rec, tracing, 9)
    _record(jrec, jtracing, 10)
    jdump = json.loads(open(jrec.dump(str(tmp_path / "j.json"))).read())
    dump = json.loads(open(rec.dump(str(tmp_path / "p.json"))).read())
    for doc in (jdump, dump):
        spans = attribution.spans_from_chrome(doc)
        assert spans == jattribution.spans_from_chrome(doc)
        assert attribution.doctor_report(spans) == \
            jattribution.doctor_report(spans)


def test_categories_and_the_kernel_prefix():
    for name in NAMES + ("xla.compile", "sign.batch", "verify.grouped",
                         "verify.batch", "fastsync.lookahead",
                         "telemetry.merge", "consensus.height"):
        assert tracing.default_category(name) == \
            jtracing.default_category(name)
    assert tracing.default_category("kernel.build") == tracing.CAT_COMPILE
    assert tracing.default_category("kernel.firstcall") == \
        tracing.CAT_COMPILE
    assert tracing.RECORDER.capacity == 16384


def test_span_records_its_error_and_raises():
    rec = tracing.FlightRecorder(4)
    with pytest.raises(KeyError):
        with rec.span("verify.collect", lanes=3):
            raise KeyError("x")
    (s,) = rec.snapshot()
    assert s["args"] == {"lanes": 3, "error": "KeyError"}
    assert s["cat"] == tracing.CAT_DEVICE


def test_backend_spans_and_metrics_on_the_cpu():
    """`CudaBackend(device="cpu")`'s raw verify records `verify.batch`
    and its metrics; the first launch of an entry is a
    `kernel.firstcall`; the asynchronous route's `collect()` is the
    `verify.collect` span with the lanes it passed counted."""
    from tendermint_tpu_torch.crypto import backend as cb
    from tendermint_tpu_torch.crypto import pure_ed25519 as ref
    be = cb.CudaBackend(device="cpu")
    seeds = [bytes([9, i]) + bytes(30) for i in range(3)]
    pubs = np.array([list(ref.pubkey_from_seed(s)) for s in seeds],
                    np.uint8)
    msgs = np.array([list(b"m%031d" % i) for i in range(3)], np.uint8)
    sigs = np.array([list(ref.sign(s, bytes(m)))
                     for s, m in zip(seeds, msgs)], np.uint8)
    sigs[2, 5] ^= 1
    cb._launch_shapes.pop("verify_batch", None)
    before = REGISTRY.snapshot()
    n0 = tracing.RECORDER.total
    assert be.verify_batch(pubs, msgs, sigs).tolist() == [True, True, False]
    after = REGISTRY.snapshot()
    assert after["sigs_requested"] - before["sigs_requested"] == 3
    assert after["sigs_verified"] - before["sigs_verified"] == 2
    assert after["verify_batches"] - before["verify_batches"] == 1
    assert after["h2d_bytes"] - before["h2d_bytes"] == 16 * (32 + 32 + 64)
    assert after["d2h_bytes"] - before["d2h_bytes"] == 16
    spans = tracing.RECORDER.recent(tracing.RECORDER.total - n0)
    names = [s["name"] for s in spans]
    assert names == ["verify.batch", "kernel.firstcall"]
    # a seen shape is a hit, a new shape on a warm entry a "recompile"
    hits, recomp = REGISTRY.xla_cache_hits.value, \
        REGISTRY.xla_recompiles.value
    lanes = (np.zeros((16, 32), np.uint8),) * 2 + (np.zeros((16, 64),
                                                           np.uint8),)
    assert cb._note_dispatch("verify_batch", *lanes) is False
    assert cb._note_dispatch("verify_batch", lanes[0][:8]) is False
    assert REGISTRY.xla_cache_hits.value - hits == 1
    assert REGISTRY.xla_recompiles.value - recomp == 1
    first = next(s for s in spans if s["name"] == "kernel.firstcall")
    assert first["cat"] == "compile"
    assert first["args"] == {"entry": "verify_batch"}


def test_replay_windows_partition_to_their_wall():
    """The pipelined replay's `fastsync.window` envelopes group its
    spans; the doctor's partition of each window sums to its wall."""
    from tendermint_tpu_torch.blockchain import replay as rp
    from tendermint_tpu_torch.crypto.backend import PythonBackend
    from tendermint_tpu_torch.proxy import ClientCreator
    from tendermint_tpu_torch.state.state import get_state
    from tendermint_tpu_torch.utils.db import MemDB

    from torch_chains import GoldenSigner
    chain = rp.build_chain(2, 12, GoldenSigner(), payload=64)
    state = get_state(MemDB(), chain.genesis)
    conns = ClientCreator("kvstore").new_app_conns()
    tracing.RECORDER.clear()
    res = rp.replay_pipelined(state, conns.consensus, chain.blocks,
                              chain.commits, PythonBackend(), window=4)
    spans = tracing.RECORDER.snapshot()
    rows = attribution.window_attribution(spans)
    assert [r["window"] for r in rows] == [1, 5, 9]
    assert res.height == 12
    for r in rows:
        parts = sum(r[k] for k in ("compile", "transfer", "device_busy",
                                   "scalar_tail", "device_idle"))
        assert parts == pytest.approx(r["wall"], rel=1e-12, abs=1e-12)
        assert r["scalar_tail"] > 0       # the golden backend's verifies
    assert jattribution.doctor_report(spans) == \
        attribution.doctor_report(spans)


def test_device_trace_across_threads(tmp_path):
    """A capture started on one thread and stopped on another exports a
    Chrome trace; a second start while one runs answers False, and so
    does a start under the calling thread's own profiler."""
    d = str(tmp_path / "cap")
    box = []
    t = threading.Thread(target=lambda: box.append(
        trace.start_device_trace(d)))
    t.start()
    t.join()
    assert box == [True]
    try:
        assert trace.start_device_trace(str(tmp_path / "other")) is False
        x = torch.ones(64, 64)
        for _ in range(3):
            x = x @ x
    finally:
        out = []
        t = threading.Thread(target=lambda: out.append(
            trace.stop_device_trace()))
        t.start()
        t.join()
    assert out == [d]
    doc = json.load(open(os.path.join(d, trace.DEVICE_TRACE_FILE)))
    assert "traceEvents" in doc
    assert trace.stop_device_trace() is None
    from torch.profiler import profile
    with profile():
        assert trace.start_device_trace(str(tmp_path / "nested")) is False
    assert "MainThread" in trace.thread_stacks()
