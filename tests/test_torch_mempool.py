"""The port's mempool admission slice against the JAX package's.

* One op sequence through the JAX `Mempool` (its batch plane running the
  scalar verifier, as `tests/test_mempool.py` does, so there is no JAX
  compile) and through the port's `Mempool` on a `BatchPlane` over
  `CudaBackend(device="cpu")` (kernel K5's plain version): unsigned,
  signed, bad-signature, malformed, secp256k1 and duplicate txs, the count
  and byte caps, priority eviction, backpressure, `update` with recheck
  and WAL recovery.  Results, evictions, reap order, sizes and the
  recovered pool must be equal.
* The batch plane's scheduling contract (priority classes, full before
  deadline, fairness truncation, per-flush fault isolation, raw lanes
  merging across producers).
* `build_corpus` byte-equal to the JAX one for one seed.
* A small threaded ingress run (8 threads, 62 submissions, 2 blocks):
  accounting, each admitted tx committed once, and the app hash equal to
  the JAX kvstore over the same blocks.
"""

import os
import random
import time

import numpy as np
import pytest
import torch

import tendermint_tpu.crypto.backend as jcb
from tendermint_tpu import batchplane as jbatchplane
from tendermint_tpu.abci.app import Application as JApplication
from tendermint_tpu.abci.app import create_app as jcreate_app
from tendermint_tpu.abci.types import Result as JResult
from tendermint_tpu.config import MempoolConfig as JMempoolConfig
from tendermint_tpu.crypto import secp256k1 as jsecp
from tendermint_tpu.mempool.mempool import Mempool as JMempool
from tendermint_tpu.mempool.mempool import parse_signed_tx
from tendermint_tpu.mempool.mempool import sign_tx_ed25519 as jsign
from tendermint_tpu.mempool.mempool import sign_tx_secp256k1 as jsign_secp
from tendermint_tpu.proxy import ClientCreator as JClientCreator
from tendermint_tpu.scenarios import loadgen as jloadgen
from tendermint_tpu.types.keys import _verify_memo as j_verify_memo
from tendermint_tpu_torch.abci.app import Application
from tendermint_tpu_torch.abci.types import Result
from tendermint_tpu_torch.batchplane import BatchPlane
from tendermint_tpu_torch.batchplane.scheduler import (Submission,
                                                       _PendingBatch)
from tendermint_tpu_torch.config import MempoolConfig
from tendermint_tpu_torch.crypto import pure_ed25519 as ref
from tendermint_tpu_torch.crypto.backend import CudaBackend
from tendermint_tpu_torch.mempool.mempool import Mempool, sign_tx_ed25519
from tendermint_tpu_torch.proxy import ClientCreator
from tendermint_tpu_torch.scenarios import ingress, loadgen


@pytest.fixture(autouse=True, scope="module")
def _share_cores():
    """xdist runs several files at once: a worker's share of the cores for
    torch keeps the plain versions' wide tensor ops from oversubscribing
    them (several torch pools on the same cores run ~20x slower)."""
    n = torch.get_num_threads()
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cpu_backend():
    return CudaBackend(device="cpu")


# -- the op sequence, on both packages -----------------------------------


def _rule(tx: bytes, height: int) -> tuple:
    """The test app's CheckTx: vetoes `veto` txs, and `stale` ones once a
    block is committed (so the recheck after `update` drops them)."""
    if tx.startswith(b"veto"):
        return 7, "vetoed"
    if tx.startswith(b"stale") and height > 0:
        return 8, "stale"
    return 0, ""


class _JApp(JApplication):
    height = 0

    def check_tx(self, tx):
        code, log = _rule(tx, self.height)
        return JResult(code=code, log=log)


class _App(Application):
    height = 0

    def check_tx(self, tx):
        code, log = _rule(tx, self.height)
        return Result(code=code, log=log)


def _flip(tx: bytes, i: int) -> bytes:
    return tx[:i] + bytes([tx[i] ^ 1]) + tx[i + 1:]


@pytest.fixture(scope="module")
def txs():
    """The sequence's txs, made once with the JAX package's helpers."""
    t = {
        "a": b"a=1",
        "sv": jsign(b"\x31" * 32, b"sv=1", priority=1),
        "sbad": _flip(jsign(b"\x32" * 32, b"sb=1", priority=2), 40),
        "malformed": bytes([0xE1, 3]) + b"short",
        "veto": b"veto=1",
        "stale": b"stale=1",
        "b": b"b=2",
        "c": b"c=3",
        "d": b"d=4",
        "hi": jsign(b"\x33" * 32, b"hi=1", priority=9),
        "big": jsign(b"\x34" * 32, b"big=" + b"x" * 300, priority=5),
        "toobig": b"z=" + b"y" * 700,
        "bp": jsign(b"\x35" * 32, b"bp=1", priority=9),
        "stale2": b"stale=2",
    }
    if jsecp.AVAILABLE:
        t["secp"] = jsign_secp(jsecp.PrivKeySecp256k1(b"\x11" * 32),
                               b"sc=1", priority=1)
    else:
        t["secp"] = bytes([0xE2, 1]) + b"\x02" * 33 + bytes([8]) + \
            b"\x30" * 8 + b"sc=1"
    return t


def _drive(mp, app, queue_lanes, txs, wal_path, reopen) -> dict:
    """Run the op sequence on one package's mempool; return what it saw.
    `queue_lanes()` parks two mempool-class lanes on the plane and
    returns their submissions; `reopen()` makes a fresh pool on the same
    journal."""
    seen = {"results": [], "evicted": []}
    mp.on_evict = lambda h, tx, p: seen["evicted"].append((tx, p))

    def check(name):
        r = mp.check_tx(txs[name])
        seen["results"].append((name, None if r is None
                                else (r.code, r.log)))

    for name in ("a", "sv", "sbad", "malformed", "a", "sv", "veto", "secp",
                 "stale", "b", "c", "d", "hi", "hi", "big", "toobig"):
        check(name)
    seen["after_caps"] = (mp.size(), mp.size_bytes(), mp.reap(-1))
    parked = queue_lanes()
    check("bp")                             # backpressure: not verified
    for sub in parked:
        sub.wait()
    check("bp")                             # now admitted, evicting big
    check("stale2")
    seen["reap"] = (mp.reap(-1), mp.reap(1))
    app.height = 1
    mp.lock()
    try:
        mp.update(1, mp.reap(1))
    finally:
        mp.unlock()
    seen["after_update"] = (mp.size(), mp.size_bytes(), mp.reap(-1))
    check("sv")                             # evicted earlier: judged anew
    check("hi")                             # committed: cache duplicate
    mp.close()
    fresh = reopen()
    seen["recovered"] = (fresh.recover_wal(), fresh.reap(-1),
                         fresh.size_bytes())
    return seen


def _lanes(n):
    pubs = np.zeros((n, 32), np.uint8)
    return pubs, np.zeros((n, 32), np.uint8), np.zeros((n, 64), np.uint8)


def test_mempool_sequence_matches_reference(txs, tmp_path, monkeypatch,
                                            cpu_backend):
    assert sign_tx_ed25519(b"\x31" * 32, b"sv=1", priority=1) == txs["sv"]

    def scalar_batch(pubs, msgs, sigs):
        return np.asarray([j_verify_memo(bytes(p), bytes(m), bytes(s))
                           for p, m, s in zip(pubs, msgs, sigs)], bool)

    monkeypatch.setattr(jcb, "verify_batch", scalar_batch)
    jbatchplane.reset_plane()
    jcfg = JMempoolConfig(max_txs=6, max_bytes=600, backpressure_lanes=2)
    japp = _JApp()
    jwal = str(tmp_path / "jax.wal")

    def jpool():
        return JMempool(JClientCreator(japp).new_app_conns().mempool, jcfg,
                        wal_path=jwal)

    def jpark():
        return [jbatchplane.get_plane().submit_raw(
            *_lanes(2), producer="flood", klass="mempool", max_wait=1.0)]

    try:
        want = _drive(jpool(), japp, jpark, txs, jwal, jpool)
    finally:
        jbatchplane.reset_plane()

    plane = BatchPlane(cpu_backend)
    cfg = MempoolConfig(max_txs=6, max_bytes=600, backpressure_lanes=2)
    app = _App()
    wal = str(tmp_path / "port.wal")

    def pool():
        return Mempool(ClientCreator(app).new_app_conns().mempool, cfg,
                       wal_path=wal, plane=plane)

    def park():
        return [plane.submit_raw(*_lanes(2), producer="flood",
                                 klass="mempool", max_wait=1.0)]

    try:
        got = _drive(pool(), app, park, txs, wal, pool)
    finally:
        plane.stop()
    assert got == want
    codes = dict(reversed(got["results"][:16]))     # first of each name
    assert codes["a"] == (0, "") and codes["sbad"][0] == 3
    assert codes["malformed"][0] == 1 and codes["veto"] == (7, "vetoed")
    assert codes["d"][0] == codes["toobig"][0] == 4
    assert [r for n, r in got["results"] if n == "bp"][0] == (
        4, "mempool backpressure: verify plane saturated")
    assert (txs["a"], 0) in got["evicted"] and len(got["evicted"]) >= 5
    assert got["recovered"][0] == got["after_update"][0] + 1


# -- the batch plane's scheduling contract -------------------------------


class _Recorder:
    """A backend stand-in: records each flush, answers lane i with
    i % 2 == 0, and raises while `fail` names the set key."""

    def __init__(self):
        self.calls = []
        self.fail = None

    def verify_grouped(self, set_key, val_pubs, val_idx, msgs, sigs):
        self.calls.append((set_key, len(val_idx)))
        if set_key == self.fail:
            raise RuntimeError("injected verify fault")
        return np.arange(len(val_idx)) % 2 == 0


def _grouped(plane, key, n, producer, klass, max_wait):
    vp = np.zeros((4, 32), np.uint8)
    return plane.submit_grouped(key, vp, np.arange(n) % 4,
                                np.zeros((n, 96), np.uint8),
                                np.zeros((n, 64), np.uint8),
                                producer=producer, klass=klass,
                                max_wait=max_wait)


def _sub(producer, klass, deadline=0.0):
    return Submission("grouped", ("grouped", b"k", 96), producer, klass,
                      deadline, (None,), 1)


def test_plane_priority_classes():
    """Among ready batches the higher class ships first, for full and
    for due batches alike."""
    p = BatchPlane(_Recorder(), target_lanes=4)
    light = _PendingBatch(("grouped", b"light", 96))
    cons = _PendingBatch(("grouped", b"cons", 96))
    for _ in range(4):
        light.add(_sub("light", "light"))
        cons.add(_sub("consensus", "consensus"))
    with p._cond:
        p._pending[light.key] = light       # light queued first
        p._pending[cons.key] = cons
        assert p._next_flush_locked() == (cons, "full")
    p = BatchPlane(_Recorder(), target_lanes=1024)
    past = time.perf_counter() - 1.0
    light = _PendingBatch(("grouped", b"light", 96))
    light.add(_sub("light", "light", deadline=past - 0.5))
    cons = _PendingBatch(("grouped", b"cons", 96))
    cons.add(_sub("consensus", "consensus", deadline=past))
    with p._cond:
        p._pending[light.key] = light
        p._pending[cons.key] = cons
        assert p._next_flush_locked() == (cons, "deadline")


def test_plane_full_flush_before_deadline_and_deadline_flush():
    flushes = []
    be = _Recorder()
    p = BatchPlane(be, target_lanes=8,
                   on_flush=lambda k, r, n, prods: flushes.append(
                       (k, r, n, sorted(prods))))
    try:
        a = _grouped(p, b"set", 3, "consensus", "consensus", 30.0)
        b = _grouped(p, b"set", 5, "light", "light", 30.0)
        assert a.wait().tolist() == [True, False, True]
        assert b.wait().tolist() == [False, True, False, True, False]
        t0 = time.perf_counter()
        c = _grouped(p, b"set", 2, "fastsync", "fastsync", 0.05)
        assert c.wait().tolist() == [True, False]
        assert time.perf_counter() - t0 < 5.0
    finally:
        p.stop()
    assert flushes == [("grouped", "full", 8, ["consensus", "light"]),
                       ("grouped", "deadline", 2, ["fastsync"])]
    assert be.calls == [(b"set", 8), (b"set", 2)]


def test_plane_fairness_truncation():
    """A truncated flush takes lanes round-robin per producer: the flood
    gets the remainder, every minority lane ships, leftovers stay."""
    p = BatchPlane(_Recorder(), target_lanes=8, max_flush_lanes=8)
    batch = _PendingBatch(("grouped", b"k", 96))
    for _ in range(50):
        batch.add(_sub("flood", "light"))
    for _ in range(4):
        batch.add(_sub("minority", "consensus"))
    with p._cond:
        p._pending[batch.key] = batch
        taken = p._take_locked(batch)
        leftover = p._pending[batch.key]
    by = {}
    for s in taken:
        by[s.producer] = by.get(s.producer, 0) + s.n
    assert by == {"flood": 4, "minority": 4}
    assert leftover.lanes == 46
    assert [s.enq_t for s in taken] == sorted(s.enq_t for s in taken)


def test_plane_failing_flush_is_isolated():
    """A flush that raises fails only its own submissions: a batch on
    another key queued beside it, and later flushes, are untouched."""
    be = _Recorder()
    be.fail = b"bad"
    p = BatchPlane(be, target_lanes=1024)
    try:
        s1 = _grouped(p, b"bad", 3, "consensus", "consensus", 0.05)
        s2 = _grouped(p, b"bad", 2, "light", "light", 0.05)
        s3 = _grouped(p, b"good", 2, "light", "light", 0.05)
        for s in (s1, s2):
            with pytest.raises(RuntimeError, match="injected"):
                s.wait()
        assert s3.wait().tolist() == [True, False]
        be.fail = None
        assert _grouped(p, b"bad", 1, "light", "light",
                        0.05).wait().tolist() == [True]
    finally:
        p.stop()


def test_plane_raw_lanes_merge_across_producers(cpu_backend):
    """Raw lanes from two producers in two classes ride one verify
    (K5's plain version), each producer getting its own verdicts."""
    rng = np.random.default_rng(41)
    seeds = [rng.integers(0, 256, 32, dtype=np.uint8).tobytes()
             for _ in range(4)]
    msgs = rng.integers(0, 256, (4, 32), dtype=np.uint8)
    pubs = np.stack([np.frombuffer(ref.pubkey_from_seed(s), np.uint8)
                     for s in seeds])
    sigs = np.stack([np.frombuffer(ref.sign(s, m.tobytes()), np.uint8)
                     for s, m in zip(seeds, msgs)])
    sigs[3, 50] ^= 1
    flushes = []
    p = BatchPlane(cpu_backend, target_lanes=4,
                   on_flush=lambda k, r, n, prods: flushes.append(
                       (k, r, n, sorted(prods))))
    try:
        a = p.submit_raw(pubs[:1], msgs[:1], sigs[:1], producer="rpc",
                         klass="mempool", max_wait=30.0)
        b = p.submit_raw(pubs[1:], msgs[1:], sigs[1:], producer="gossip",
                         klass="light", max_wait=30.0)
        assert a.wait().tolist() == [True]
        assert b.wait().tolist() == [True, True, False]
    finally:
        p.stop()
    assert flushes == [("raw", "full", 4, ["gossip", "rpc"])]


def test_plane_class_depth_counts_pending_lanes():
    p = BatchPlane(_Recorder(), target_lanes=1024)
    try:
        s = _grouped(p, b"set", 3, "mempool", "mempool", 0.3)
        _grouped(p, b"set", 2, "light", "light", 0.3)
        assert p.class_depth("mempool") == 3 and p.depth() == 2
        s.wait()
        assert p.drain(5.0) and p.class_depth("mempool") == 0
    finally:
        p.stop()
    with pytest.raises(RuntimeError, match="stopped"):
        _grouped(p, b"set", 1, "light", "light", 0.05)


# -- the load generator --------------------------------------------------


def test_build_corpus_matches_reference(cpu_backend):
    """One seed, one small mix: the port's corpus (signed in one batch,
    K3's plain version) is byte-equal to the JAX one (signed one by one on
    the host)."""
    kw = dict(unsigned=12, signed=5, bad_sig=3, dup_frac=0.25)
    want = jloadgen.build_corpus(random.Random(7), jloadgen.Mix(**kw))
    got = loadgen.build_corpus(random.Random(7), loadgen.Mix(**kw),
                               backend=cpu_backend)
    assert got == want
    assert sum(parse_signed_tx(bytes.fromhex(e["tx"])) is not None
               for e in got) >= 8


def test_loadgen_classify_and_accounting():
    """Every submission lands in one outcome, through `run` and
    `submit_each` alike; outcomes follow the `broadcast_tx_sync` shape."""
    def call(params):
        n = int(params["tx"], 16)
        if n % 11 == 0:
            raise ValueError("tx already in cache")
        if n % 13 == 0:
            raise RuntimeError("transport died")
        return {"code": (0, 4, 3, 1, 9)[n % 5], "log": "mempool is full"}

    corpus = [{"tx": "%04x" % i} for i in range(1, 40)]
    report = loadgen.LoadGen(call, corpus, workers=3).run(duration_s=0.05)
    assert sum(report.outcomes.values()) == report.offered > 0
    once, wall = loadgen.LoadGen(call, corpus, workers=4).submit_each(corpus)
    assert wall > 0
    assert [o for o, _ in once] == [loadgen.classify(call, e)
                                    for e in corpus]
    assert {o for o, _ in once} == {"admitted", "full", "bad_sig",
                                    "encoding", "app", "dup", "error"}


# -- the slice end to end ------------------------------------------------


def test_threaded_ingress_slice(cpu_backend, monkeypatch):
    """8 threads offer a 62-entry corpus in two rounds; each round ends in
    a block applied with the real mempool.  The accounting holds, every
    admitted tx is committed once, the app hash equals the JAX kvstore
    over the same blocks, and the JAX mempool admits the same txs."""
    mix = loadgen.Mix(unsigned=24, signed=24, bad_sig=6, dup_frac=0.15)
    corpus = loadgen.build_corpus(random.Random(11), mix,
                                  backend=cpu_backend)
    run = ingress.run_ingress(cpu_backend, corpus, round_size=31,
                              workers=8, n_vals=1, target_lanes=8,
                              waits={"mempool": 0.2})
    outcomes = [o for o, _ in run.results]
    assert len(outcomes) == len(corpus) == 62 and len(run.blocks) == 2
    assert set(outcomes) <= {"admitted", "dup", "bad_sig"}
    by_tx = {}
    for e, o in zip(corpus, outcomes):
        by_tx.setdefault(e["tx"], []).append(o)
    admitted = set()
    for tx, outs in by_tx.items():
        if "bad_sig" in outs:
            assert set(outs) <= {"bad_sig", "dup"}
        else:
            assert outs.count("admitted") == 1, outs
            admitted.add(bytes.fromhex(tx))
    assert len(admitted) == 48
    committed = [tx for b in run.blocks for tx in b.txs]
    assert sorted(committed) == sorted(admitted)
    assert run.mempool.size() == 0
    verified = sum(1 for e, o in zip(corpus, outcomes)
                   if o != "dup" and parse_signed_tx(bytes.fromhex(e["tx"])))
    assert sum(n for k, _, n in run.flushes if k == "raw") == verified
    assert len(run.votes) == 1 and run.votes[0].all()
    app = jcreate_app("kvstore")
    for b in run.blocks:
        for tx in b.txs:
            app.deliver_tx(tx)
        want_hash = app.commit().data
    assert run.state.app_hash == want_hash
    # the JAX mempool, fed the same corpus on one thread, admits the same
    def scalar_batch(pubs, msgs, sigs):
        return np.asarray([j_verify_memo(bytes(p), bytes(m), bytes(s))
                           for p, m, s in zip(pubs, msgs, sigs)], bool)

    monkeypatch.setattr(jcb, "verify_batch", scalar_batch)
    jbatchplane.reset_plane()
    try:
        jmp = JMempool(JClientCreator("kvstore").new_app_conns().mempool,
                       JMempoolConfig())
        jadmitted = {bytes.fromhex(e["tx"]) for e in corpus
                     if (r := jmp.check_tx(bytes.fromhex(e["tx"])))
                     is not None and r.is_ok}
    finally:
        jbatchplane.reset_plane()
    assert jadmitted == admitted
    assert not run.mempool.plane._thread.is_alive()   # the plane stopped
