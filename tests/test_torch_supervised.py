"""The port's supervised crypto ladder (`crypto/supervised.py`) held
against the JAX package's: both given the same fake rungs with the same
scripted faults (`tests/test_supervised.py`'s shapes: threshold, half-open
probe, retries, timeout, spot-check mismatch, every rung failing, the
floor's own error, the adapted grouped forms, the asynchronous route), and
their answers, raised types and messages and `supervisor_status` equal
after every step.  Then the port's rules: `build` raises when a rung
cannot be built, and the two fallbacks that catch `DeviceFault` (the
mempool's scalar verify, the light client's one retry) catch nothing
else."""

import time

import numpy as np
import pytest

from tendermint_tpu.crypto import supervised as jsup
from tendermint_tpu.utils.chaos import DeviceFault as JDeviceFault
from tendermint_tpu_torch.abci.types import ERR_BAD_SIG, OK
from tendermint_tpu_torch.batchplane import BatchPlane
from tendermint_tpu_torch.config import MempoolConfig
from tendermint_tpu_torch.crypto import pure_ed25519 as ref
from tendermint_tpu_torch.crypto import supervised as sup
from tendermint_tpu_torch.crypto.backend import PythonBackend
from tendermint_tpu_torch.crypto.supervised import DeviceFault
from tendermint_tpu_torch.light import client as light
from tendermint_tpu_torch.mempool.mempool import Mempool, sign_tx_ed25519
from tendermint_tpu_torch.p2p.connection import is_node_fault
from tendermint_tpu_torch.proxy import ClientCreator

from chainutil import build_chain, make_validators
from torch_chains import port_chain, port_vals


@pytest.fixture(autouse=True)
def _no_jax_chaos(monkeypatch):
    monkeypatch.delenv("TM_CHAOS_CRYPTO", raising=False)


def _lanes():
    """Four real lanes (the last forged) and their answers."""
    seeds = [bytes([i + 3]) * 32 for i in range(4)]
    msgs = [bytes([i]) * 40 for i in range(4)]
    sigs = [ref.sign(s, m) for s, m in zip(seeds, msgs)]
    sigs[3] = bytes(64)
    pubs = [ref.pubkey_from_seed(s) for s in seeds]
    arr = [np.frombuffer(b"".join(x), np.uint8).reshape(4, -1)
           for x in (pubs, msgs, sigs)]
    truth = {(p, m, s): ref.verify(p, m, s)
             for p, m, s in zip(pubs, msgs, sigs)}
    return arr, truth


LANES, TRUTH = _lanes()


class Scripted:
    """A rung whose calls follow a script: "ok" answers the truth,
    "raise" raises RuntimeError, "fault" the package's DeviceFault,
    "error" ValueError, "wrong" answers every lane inverted, "hang"
    sleeps past the call timeout first; past its end the script repeats
    its last step.  `collect` scripts the asynchronous route's collect."""

    def __init__(self, script, fault_type, collect=()):
        self.script = list(script)
        self.collect_script = list(collect)
        self.fault_type = fault_type
        self.calls = 0

    def _step(self, script):
        i = min(self.calls, len(script) - 1)
        self.calls += 1
        return script[i]

    def _act(self, step, pubs, msgs, sigs):
        if step == "raise":
            raise RuntimeError("simulated launch failure")
        if step == "fault":
            raise self.fault_type("simulated rung loss")
        if step == "error":
            raise ValueError("caller error")
        if step == "hang":
            time.sleep(0.3)
        out = np.array([TRUTH[(p.tobytes(), m.tobytes(), s.tobytes())]
                        for p, m, s in zip(pubs, msgs, sigs)], dtype=bool)
        return ~out if step == "wrong" else out

    def verify_batch(self, pubkeys, msgs, sigs):
        return self._act(self._step(self.script), np.asarray(pubkeys),
                         np.asarray(msgs), np.asarray(sigs))


class ScriptedAsync(Scripted):
    def verify_grouped_templated_async(self, set_key, val_pubs, val_idx,
                                       tmpl_idx, templates, sigs,
                                       real_n=None):
        step = self._step(self.script)
        pubs = np.asarray(val_pubs)[np.asarray(val_idx)]
        msgs = np.asarray(templates)[np.asarray(tmpl_idx)]
        if step != "ok":
            self._act(step, pubs, msgs, sigs)
        outs = iter(self.collect_script)

        def collect():
            return self._act(next(outs, "ok"), pubs, msgs, np.asarray(sigs))
        return collect


# (knobs, device script, floor script, steps, device class, collect script)
SCENARIOS = {
    "threshold": (dict(breaker_threshold=2, retries=1,
                       breaker_cooldown_s=30.0),
                  ["raise", "raise", "raise", "ok"], ["ok"],
                  ["batch", "batch", "batch"], Scripted, ()),
    "half_open_recovers": (dict(breaker_threshold=1, retries=0,
                                breaker_cooldown_s=0.05),
                           ["raise", "ok"], ["ok"],
                           ["batch", "batch", 0.08, "batch", "batch"],
                           Scripted, ()),
    "half_open_probe_fails": (dict(breaker_threshold=1, retries=0,
                                   breaker_cooldown_s=0.05),
                              ["raise", "raise", "ok"], ["ok"],
                              ["batch", 0.08, "batch", "batch", 0.08,
                               "batch"], Scripted, ()),
    "retries": (dict(breaker_threshold=10, retries=2),
                ["raise", "raise", "ok"], ["ok"], ["batch", "batch"],
                Scripted, ()),
    "timeout": (dict(breaker_threshold=1, call_timeout_s=0.1, retries=0,
                     breaker_cooldown_s=0.05),
                ["hang", "ok"], ["ok"], ["batch", 0.35, "batch"],
                Scripted, ()),
    "spot_check_mismatch": (dict(spot_check_every=1, breaker_threshold=2,
                                 retries=0),
                            ["wrong", "ok"], ["ok"],
                            ["batch", "batch", "batch"], Scripted, ()),
    "all_rungs_fail": (dict(breaker_threshold=1, retries=0),
                       ["raise"], ["fault"], ["batch", "batch"], Scripted,
                       ()),
    "floor_error_propagates": (dict(breaker_threshold=5, retries=0),
                               ["raise"], ["error"], ["batch"], Scripted,
                               ()),
    "grouped_forms": (dict(breaker_threshold=2, retries=0),
                      ["raise", "ok"], ["ok"],
                      ["grouped", "templated", "templated"], Scripted, ()),
    "async_collect_fault": (dict(breaker_threshold=1, retries=0,
                                 breaker_cooldown_s=30.0),
                            ["ok"], ["ok"], ["async", "async"],
                            ScriptedAsync, ["raise"]),
    "async_dispatch_fault": (dict(breaker_threshold=1, retries=0),
                             ["raise", "ok"], ["ok"], ["async", "batch"],
                             ScriptedAsync, ()),
}


def _call(be, step):
    pubs, msgs, sigs = LANES
    idx = np.arange(4, dtype=np.int32)
    if step == "batch":
        return be.verify_batch(pubs, msgs, sigs)
    if step == "grouped":
        return be.verify_grouped(b"set", pubs, idx, msgs, sigs)
    if step == "templated":
        return be.verify_grouped_templated(b"set", pubs, idx, idx, msgs,
                                           sigs)
    return be.verify_grouped_templated_async(b"set", pubs, idx, idx, msgs,
                                             sigs)()


def _status(be) -> dict:
    st = be.supervisor_status()
    for r in st["rungs"]:
        r.pop("latency_mean_s")
    return st


def _run(cls, fault_type, name):
    knobs, dev_script, floor_script, steps, dev_cls, collect = \
        SCENARIOS[name]
    dev = dev_cls(dev_script, fault_type, collect)
    floor = Scripted(floor_script, fault_type)
    be = cls([("cuda", dev), ("python", floor)], **knobs)
    trace = []
    for step in steps:
        if isinstance(step, float):
            time.sleep(step)
            continue
        try:
            out = ("ok", [bool(x) for x in _call(be, step)])
        except (RuntimeError, ValueError) as e:
            out = (type(e).__name__, str(e))
        trace.append((step, out, dev.calls, floor.calls, _status(be)))
    return trace


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_ladder_matches_jax(name):
    """Answers, raised types and messages, rung calls and
    `supervisor_status` (calls, faults, trips, recoveries, states, the
    active rung) equal after every step."""
    want = _run(jsup.SupervisedBackend, JDeviceFault, name)
    got = _run(sup.SupervisedBackend, DeviceFault, name)
    assert got == want
    answers = [o for _, o, *_ in got if o[0] == "ok"]
    assert all(o[1] == [True, True, True, False] for o in answers)


def test_device_fault_is_a_node_fault():
    assert issubclass(DeviceFault, RuntimeError)
    assert is_node_fault(DeviceFault("rung lost"))


def test_build_orders_the_ladder_and_raises_without_a_card():
    import torch
    names = lambda b: [r.name for r in b._rungs]          # noqa: E731
    assert names(sup.SupervisedBackend.build("native")) == ["native",
                                                            "python"]
    assert names(sup.SupervisedBackend.build("python")) == ["python"]
    cpu = sup.SupervisedBackend.build("cpu", breaker_threshold=7)
    assert names(cpu) == ["cpu", "python"]
    assert cpu.breaker_threshold == 7 and cpu._rungs[0].backend.name == "cuda"
    with pytest.raises(ValueError, match="unknown crypto rung"):
        sup.SupervisedBackend.build("tpu")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sup.SupervisedBackend.build("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sup.SupervisedBackend.build()


# -- the two fallbacks that catch DeviceFault ---------------------------------

class _Failing(PythonBackend):
    """The golden backend whose first `fail` verify calls raise `exc`."""

    def __init__(self, exc, fail=1 << 30):
        self.exc, self.fail, self.calls = exc, fail, 0

    def _maybe_fail(self):
        self.calls += 1
        if self.calls <= self.fail:
            raise self.exc

    def verify_batch(self, pubkeys, msgs, sigs):
        self._maybe_fail()
        return super().verify_batch(pubkeys, msgs, sigs)

    def verify_grouped_templated(self, *args):
        self._maybe_fail()
        return PythonBackend().verify_grouped_templated(*args)


def _mempool(backend):
    plane = BatchPlane(backend)
    pool = Mempool(ClientCreator("kvstore").new_app_conns().mempool,
                   MempoolConfig(), plane=plane)
    return pool, plane


def test_mempool_scalar_fallback_on_device_fault():
    """A ladder whose every rung failed: signed envelopes are checked on
    the native scalar path, a forged one still refused."""
    ladder = sup.SupervisedBackend(
        [("cuda", _Failing(RuntimeError("lost"))),
         ("python", _Failing(DeviceFault("floor lost")))],
        breaker_threshold=1, retries=0)
    pool, plane = _mempool(ladder)
    try:
        good = sign_tx_ed25519(b"\x01" * 32, b"k=v")
        bad = bytearray(sign_tx_ed25519(b"\x01" * 32, b"k=w"))
        bad[40] ^= 1
        assert pool.check_tx(good).code == OK
        assert pool.check_tx(bytes(bad)).code == ERR_BAD_SIG
        assert pool.size() == 1
    finally:
        plane.stop()
    st = ladder.supervisor_status()
    assert st["rungs"][0]["trips"] == 1 and st["rungs"][1]["faults"] == 2


def test_mempool_bare_backend_fault_still_raises():
    pool, plane = _mempool(_Failing(RuntimeError("launch failed")))
    try:
        with pytest.raises(RuntimeError, match="launch failed"):
            pool.check_tx(sign_tx_ed25519(b"\x01" * 32, b"k=v"))
    finally:
        plane.stop()


@pytest.fixture(scope="module")
def chain():
    privs, vs = make_validators(4, seed=0)
    return port_vals(vs), port_chain(build_chain(
        privs, vs, "retry-chain", 2, txs_per_block=1))


def _update(backend, chain):
    vs, blocks = chain
    plane = BatchPlane(backend)
    lc = light.LightClient("retry-chain", light.TrustedState(0, b"", vs),
                           plane)
    try:
        block, _, seen = blocks[0]
        return lc, lc.update(light.SignedHeader(block.header, seen), vs)
    finally:
        plane.stop()


def test_light_client_retries_once_on_device_fault(chain):
    be = _Failing(DeviceFault("rung lost"), fail=1)
    lc, trusted = _update(be, chain)
    assert trusted.height == 1 and be.calls == 2


def test_light_client_second_device_fault_propagates(chain):
    be = _Failing(DeviceFault("rung lost"), fail=2)
    with pytest.raises(DeviceFault):
        _update(be, chain)
    assert be.calls == 2


def test_light_client_bare_fault_is_not_retried(chain):
    be = _Failing(RuntimeError("launch failed"), fail=1)
    with pytest.raises(RuntimeError, match="launch failed"):
        _update(be, chain)
    assert be.calls == 1
