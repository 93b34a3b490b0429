"""The port's chaos primitives held against the JAX package's, with zero
tolerance: `derive_seed`, `CryptoChaos` (specs accepted and refused, the
raise, latency and wrong schedules, `corrupt`), `ChaosConfig`
validation, the `FuzzedConnection` decisions and bytes over a scripted
stream, fail points armed by index and by name, and the supervised
ladder with chaos set (its answers and `supervisor_status`).  Then the
port's own rules: no environment variable arms anything, and the switch
wraps its links when `P2PConfig.fuzz` is set."""

import random
import time
from types import SimpleNamespace

import numpy as np
import pytest

from tendermint_tpu.crypto import supervised as jsup
from tendermint_tpu.crypto.backend import PythonBackend as JPythonBackend
from tendermint_tpu.p2p import fuzz as jfuzz
from tendermint_tpu.utils import chaos as jchaos
from tendermint_tpu.utils import fail as jfail
from tendermint_tpu_torch.crypto import pure_ed25519 as ref
from tendermint_tpu_torch.crypto import supervised as sup
from tendermint_tpu_torch.crypto.backend import PythonBackend
from tendermint_tpu_torch.p2p import fuzz
from tendermint_tpu_torch.utils import chaos
from tendermint_tpu_torch.utils import fail

pytestmark = pytest.mark.faults


@pytest.fixture(autouse=True)
def _no_env_chaos(monkeypatch):
    for k in ("TM_CHAOS_CRYPTO", "TM_CHAOS_SEED", "TM_FAIL_INDEX",
              "TM_FAIL_POINT"):
        monkeypatch.delenv(k, raising=False)
    jchaos.install(None)


SEEDS = [0, 1, 7, 11, 20260806, 2**40 + 3, -5]
LABELS = [(), ("p2p.fuzz", "0"), ("p2p.fuzz", "17"), ("p2p.reconnect",
          "ab" * 20), ("byz-equivocation", "rng", "equivocation"),
          ("live-rounds-100-chaos", "rng", "live-adversary")]


@pytest.mark.parametrize("seed", SEEDS)
def test_derive_seed_equals_jax(seed):
    for labels in LABELS:
        assert chaos.derive_seed(seed, *labels) == \
            jchaos.derive_seed(seed, *labels)
        assert chaos.ChaosConfig(seed).derive_seed(*labels) == \
            jchaos.ChaosConfig(seed).derive_seed(*labels)


SPECS = ["raise", "raise:every=3", "latency:ms=2,every=4",
         "wrong:lanes=2,every=3", "wrong:lanes=1", " raise : every=5 ",
         "raise:every=0", "boom:every=1", "raise:every", "raise:foo=1",
         "latency:ms=x", "wrong:lanes=1,,every=2", "", "raise:every=-1"]


def _parse(mod, spec):
    try:
        c = mod.CryptoChaos.parse(spec)
    except Exception as e:  # noqa: BLE001 - compared across packages
        return type(e).__name__, str(e)
    return c.mode, c.every, c.ms, c.lanes, c.active


@pytest.mark.parametrize("spec", SPECS)
def test_parse_accepts_and_refuses_as_jax(spec):
    assert _parse(chaos, spec) == _parse(jchaos, spec)


def _schedule(mod, spec, n=100):
    c = mod.CryptoChaos.parse(spec)
    out, sleeps = [], []
    real_time = mod.time
    mod.time = SimpleNamespace(sleep=sleeps.append)
    try:
        rng = np.random.default_rng(5)
        for i in range(n):
            if i == 60:
                c.active = False          # "clear" the storm mid-run
            if i == 80:
                c.active = True
            try:
                c.before_call()
                got = "ok"
            except mod.DeviceFault as e:
                got = str(e)
            lanes = rng.integers(0, 2, 1 + i % 5).astype(bool)
            out.append((got, c.corrupt(lanes).tolist(), c.calls))
    finally:
        mod.time = real_time
    return out, sleeps


@pytest.mark.parametrize("spec", ["raise:every=3", "raise",
                                  "latency:ms=7,every=4",
                                  "wrong:lanes=2,every=3",
                                  "wrong:lanes=9,every=1"])
def test_chaos_schedules_equal_jax_over_100_calls(spec):
    assert _schedule(chaos, spec) == _schedule(jchaos, spec)


@pytest.mark.parametrize("kw", [dict(), dict(seed=3),
                                dict(seed=3, crypto="raise:every=2"),
                                dict(seed=True), dict(seed=1.5),
                                dict(seed="3"), dict(crypto=""),
                                dict(crypto="nope"), dict(crypto=5)])
def test_chaos_config_validation_matches_jax(kw):
    def build(mod):
        try:
            c = mod.ChaosConfig(**kw)
        except Exception as e:  # noqa: BLE001 - compared across packages
            return type(e).__name__, str(e).replace("tendermint_tpu_torch",
                                                    "tendermint_tpu")
        return c.seed, None if c.crypto is None else (
            c.crypto.mode, c.crypto.every)
    assert build(chaos) == build(jchaos)


def test_no_environment_knob_reaches_the_port(monkeypatch):
    """The JAX package reads TM_CHAOS_CRYPTO / TM_FAIL_INDEX; the port
    reads neither: a ladder gets chaos only through chaos=, and a fail
    point fires only once armed."""
    monkeypatch.setenv("TM_CHAOS_CRYPTO", "raise:every=1")
    monkeypatch.setenv("TM_FAIL_INDEX", "0")
    ladder = sup.SupervisedBackend([("dev", PythonBackend()),
                                    ("python", PythonBackend())])
    assert ladder.chaos is None
    assert ladder.supervisor_status()["chaos"] is None
    hits = []
    fail.set_callback(lambda n, i: hits.append((n, i)))
    try:
        fail.fail_point("ApplyBlock.validated")
    finally:
        fail.set_callback(None)
    assert hits == []
    assert not hasattr(chaos, "install") and not hasattr(chaos, "installed")
    assert not hasattr(chaos.CryptoChaos, "from_env")


# -- the fuzzed connection --------------------------------------------------

class _Sink:
    """A conn that records writes and answers reads with counted bytes."""

    def __init__(self):
        self.written = []
        self.reads = 0
        self.closed = False
        self.label = "sink"

    def write(self, data):
        self.written.append(bytes(data))

    def read_exact(self, n):
        self.reads += 1
        return bytes([self.reads % 256]) * n

    def close(self):
        self.closed = True


def _fuzz_trace(mod, **kw):
    sleeps = []
    real_time = mod.time
    mod.time = SimpleNamespace(sleep=sleeps.append)
    try:
        return _fuzz_steps(mod, sleeps, **kw)
    finally:
        mod.time = real_time


def _fuzz_steps(mod, sleeps, **kw):
    sink = _Sink()
    fc = mod.FuzzedConnection(sink, seed=1234, **kw)
    rng = random.Random(9)
    got = []
    for i in range(300):
        if i == 100:
            fc.set_profile(read_drop_prob=1.0, read_stall=0.5)
        if i == 150:
            fc.set_profile(read_drop_prob=0.0, write_garbage_prob=0.3)
        if i == 220:
            fc.set_profile(write_drop_prob=0.0, write_delay_prob=0.0,
                           read_delay_prob=0.0, write_garbage_prob=0.0)
        if rng.random() < 0.5:
            fc.write(bytes(rng.randrange(256) for _ in range(1 + i % 40)))
            got.append(("w", len(sink.written)))
        else:
            got.append(("r", fc.read_exact(1 + i % 7)))
        got.append(("s", len(sleeps)))
    with pytest.raises(ValueError, match="unknown fuzz profile"):
        fc.set_profile(drop_probability=1.0)
    return got, sleeps, sink.written, fc.label, fc.drop_prob, fc.delay_prob


@pytest.mark.parametrize("kw", [
    dict(drop_prob=0.1, delay_prob=0.2, max_delay=0.05),
    dict(read_drop_prob=0.05, read_delay_prob=0.3, write_drop_prob=0.2,
         write_delay_prob=0.1, max_delay=0.01, read_stall=2.0),
    dict()])
def test_fuzzed_connection_decides_and_writes_as_jax(kw):
    assert _fuzz_trace(fuzz, **kw) == _fuzz_trace(jfuzz, **kw)


def test_fuzzed_connection_seeds_are_derived_never_random():
    """A link needs its seed (no `random.Random(None)`), the switch's
    derivation is the JAX label, and a live link is listed."""
    with pytest.raises(TypeError):
        fuzz.FuzzedConnection(_Sink())
    fc = fuzz.FuzzedConnection(_Sink(), seed=fuzz.derived_seed(4, 11))
    assert fc.seed == jchaos.derive_seed(11, "p2p.fuzz", "4")
    assert fc in fuzz.live_connections()


# -- fail points ------------------------------------------------------------

NAMES = ["consensus.finalizeCommit.validated", "ApplyBlock.validated",
         "ApplyBlock.executed", "ApplyBlock.savedResponses",
         "ApplyBlock.committed", "consensus.finalizeCommit.savedBlock",
         "Snapshot.chunkWritten", "Snapshot.chunksWritten"] * 2


def _fire(mod, names):
    hits = []
    mod.set_callback(lambda n, i: hits.append((n, i)))
    try:
        for n in names:
            mod.fail_point(n)
    finally:
        mod.set_callback(None)
    return hits


@pytest.mark.parametrize("target", [0, 3, 9, ("name", "ApplyBlock.executed"),
                                    ("name", "Snapshot.chunksWritten")])
def test_armed_fail_point_fires_as_jax(monkeypatch, target):
    monkeypatch.setattr(jfail, "_counter", 0)
    if isinstance(target, tuple):
        monkeypatch.setenv("TM_FAIL_POINT", target[1])
        fail.arm(name=target[1])
    else:
        monkeypatch.setenv("TM_FAIL_INDEX", str(target))
        fail.arm(index=target)
    try:
        assert _fire(fail, NAMES) == _fire(jfail, NAMES)
    finally:
        fail.disarm()
    assert _fire(fail, NAMES) == []


def test_fail_points_stand_at_the_jax_sites(monkeypatch):
    """A port consensus net passes the same named points in the same
    order per committed height, as the JAX sites do."""
    from tendermint_tpu_torch.consensus import state as cstate
    from tendermint_tpu_torch.scenarios import harness
    from tendermint_tpu_torch.state import execution
    hits = []
    monkeypatch.setattr(cstate, "fail_point", hits.append)
    monkeypatch.setattr(execution, "fail_point", hits.append)
    nodes, _, _ = harness.wire_net("fail-chain", 1, seed=3,
                                   backend=PythonBackend())
    nodes[0].cs.start()
    try:
        assert harness.wait_until(
            lambda: nodes[0].block_store.height >= 2, timeout=30)
    finally:
        harness.stop_wire_net(nodes)
    one_height = ["consensus.finalizeCommit.validated",
                  "consensus.finalizeCommit.savedBlock",
                  "consensus.finalizeCommit.waledHeight",
                  "ApplyBlock.validated", "ApplyBlock.executed",
                  "ApplyBlock.savedResponses", "ApplyBlock.committed",
                  "consensus.finalizeCommit.applied"]
    assert hits[:16] == one_height * 2


# -- the supervised ladder with chaos ---------------------------------------

def _lanes(n=3):
    seeds = [bytes([i + 9]) * 32 for i in range(n)]
    msgs = [bytes([i]) * 32 for i in range(n)]
    sigs = [ref.sign(s, m) for s, m in zip(seeds, msgs)]
    sigs[-1] = sigs[-1][:-1] + bytes([sigs[-1][-1] ^ 1])
    pubs = [ref.pubkey_from_seed(s) for s in seeds]
    return [np.frombuffer(b"".join(x), np.uint8).reshape(n, -1)
            for x in (pubs, msgs, sigs)]


def _status(be):
    st = be.supervisor_status()
    for r in st["rungs"]:
        r.pop("latency_mean_s")
    return st


@pytest.mark.parametrize("spec,knobs", [
    ("raise:every=2", dict(breaker_threshold=2, breaker_cooldown_s=0.0,
                           retries=0)),
    ("wrong:lanes=1,every=3", dict(breaker_threshold=3, retries=0,
                                   spot_check_every=1)),
    ("latency:ms=1,every=2", dict(retries=1)),
    ("raise:every=1", dict(breaker_threshold=1, breaker_cooldown_s=30.0,
                           retries=0))])
def test_ladder_with_chaos_matches_jax(spec, knobs):
    """The same chaos on the same two-rung ladders: every answer, the
    chaos call counter and `supervisor_status` (its "chaos" field among
    them) equal after each call, and after the storm clears."""
    port = sup.SupervisedBackend(
        [("dev", PythonBackend()), ("python", PythonBackend())],
        call_timeout_s=10.0, chaos=chaos.CryptoChaos.parse(spec), **knobs)
    jax = jsup.SupervisedBackend(
        [("dev", JPythonBackend()), ("python", JPythonBackend())],
        call_timeout_s=10.0, chaos=jchaos.CryptoChaos.parse(spec), **knobs)
    lanes = _lanes()
    want = [ref.verify(*(a[i].tobytes() for a in lanes)) for i in range(3)]
    for step in range(9):
        if step == 6:
            port.chaos.active = jax.chaos.active = False
        got = port.verify_batch(*lanes).tolist()
        assert got == jax.verify_batch(*lanes).tolist() == want
        assert port.chaos.calls == jax.chaos.calls
        assert _status(port) == _status(jax)
    assert _status(port)["chaos"] is None


def test_chaos_reaches_only_device_rungs_and_the_async_route():
    """The floor takes no chaos; the asynchronous dispatch and its collect
    are injected like a synchronous call."""
    port = sup.SupervisedBackend([("python", PythonBackend())],
                                 chaos=chaos.CryptoChaos.parse("raise"))
    lanes = _lanes()
    assert port.verify_batch(*lanes).tolist() == [True, True, False]
    assert port.chaos.calls == 0
    assert port.supervisor_status()["chaos"] == "raise:every=1"

    def async_rung(base):
        class AsyncRung(base):
            def verify_grouped_templated_async(self, set_key, val_pubs,
                                               val_idx, tmpl_idx, templates,
                                               sigs, real_n=None):
                out = self.verify_batch(np.asarray(val_pubs)[val_idx],
                                        np.asarray(templates)[tmpl_idx],
                                        sigs)
                return lambda: out
        return AsyncRung()

    pubs, msgs, sigs = lanes
    idx = np.arange(3)
    for spec in ("raise:every=2", "wrong:lanes=3,every=2"):
        ladders = [
            mod.SupervisedBackend(
                [("dev", async_rung(be)), ("python", be())],
                breaker_threshold=5, retries=0, spot_check_every=1,
                chaos=cmod.CryptoChaos.parse(spec))
            for mod, be, cmod in ((sup, PythonBackend, chaos),
                                  (jsup, JPythonBackend, jchaos))]
        for _ in range(4):
            got = [lad.verify_grouped_templated_async(
                b"k", pubs, idx, idx, msgs, sigs)().tolist()
                for lad in ladders]
            assert got[0] == got[1]
            assert ladders[0].chaos.calls == ladders[1].chaos.calls
            assert _status(ladders[0]) == _status(ladders[1])
        assert ladders[0].chaos.calls >= 4


def test_device_fault_lives_in_chaos_and_is_reexported():
    from tendermint_tpu_torch.light import client
    from tendermint_tpu_torch.mempool import mempool
    assert sup.DeviceFault is chaos.DeviceFault
    assert mempool.DeviceFault is client.DeviceFault is chaos.DeviceFault
    assert issubclass(chaos.DeviceFault, RuntimeError)


# -- the switch --------------------------------------------------------------

def test_switch_accepts_fuzz_and_seeds_links_from_its_chaos_seed():
    """`P2PConfig.fuzz` wraps every link; the i-th link of a switch is
    seeded with derive_seed(chaos_seed, "p2p.fuzz", str(i)) and its
    reconnect jitter with the JAX "p2p.reconnect" label.  A fuzzed port
    switch still talks to a JAX switch."""
    from tendermint_tpu.p2p import switch as jswitch
    from tendermint_tpu_torch.config import P2PConfig
    from tendermint_tpu_torch.p2p.switch import connect_switches, make_switch
    cfg = P2PConfig(laddr="", fuzz=True, fuzz_drop_prob=0.0,
                    fuzz_delay_prob=0.0)
    sw = make_switch("fuzz-chain", {}, config=cfg, chaos_seed=21)
    others = [make_switch("fuzz-chain", {}) for _ in range(2)]
    for s in [sw] + others:
        s.start()
    try:
        for o in others:
            connect_switches(sw, o)
        links = [p.mconn.conn._conn for p in sw.peers()]
        assert [type(c) for c in links] == [fuzz.FuzzedConnection] * 2
        assert sorted(c.seed for c in links) == sorted(
            jchaos.derive_seed(21, "p2p.fuzz", str(i)) for i in range(2))
        want = random.Random(jchaos.derive_seed(21, "p2p.reconnect",
                                                sw.node_info.id))
        assert sw._reconnect_rng.random() == want.random()
        jsw = jswitch.make_switch("fuzz-chain", {}, moniker="jax")
        jsw.start()
        try:
            c1, c2 = __import__(
                "tendermint_tpu_torch.p2p.transport",
                fromlist=["mem_pair"]).mem_pair()
            import threading
            t = threading.Thread(target=jsw.add_peer_from_conn,
                                 args=(c2, False), daemon=True)
            t.start()
            sw.add_peer_from_conn(c1, outbound=True)
            t.join(timeout=10)
            deadline = time.time() + 10
            while sw.n_peers() < 3 and time.time() < deadline:
                time.sleep(0.02)
            assert sw.n_peers() == 3 and jsw.n_peers() == 1
        finally:
            jsw.stop()
    finally:
        for s in [sw] + others:
            s.stop()
