"""The port's lock-order witness (`tendermint_tpu_torch/utils/lockwitness.py`)
held to the JAX module's behaviour: the eight cases of
`tests/test_lockwitness.py` (inversions raise deterministically,
reentrancy and consistent orders stay silent, `new_lock` is a plain
lock unless the witness is on) on both packages where both can run
them, with the port's own switch: the witness turns on only by an
explicit call (`enable()` / `witnessing()`), `TM_LOCK_WITNESS=1` changes
nothing, and the eight wired sites carry the JAX role names."""

import threading

import pytest

from tendermint_tpu.utils import lockwitness as jlw
from tendermint_tpu_torch.utils import lockwitness as lw
from tendermint_tpu_torch.utils.lockwitness import LockOrderError, WitnessLock

PACKAGES = {"port": lw, "jax": jlw}


@pytest.fixture(autouse=True)
def fresh_graph():
    for m in PACKAGES.values():
        m.reset()
    lw.disable()
    yield
    lw.disable()
    for m in PACKAGES.values():
        m.reset()


@pytest.fixture(params=sorted(PACKAGES))
def mod(request):
    return PACKAGES[request.param]


def test_inversion_raises_on_second_order(mod):
    a, b = mod.WitnessLock("A"), mod.WitnessLock("B")
    with a:
        with b:
            pass
    errs = []

    def inverted():
        try:
            with b:
                with a:
                    pass
        except mod.LockOrderError as e:
            errs.append(e)

    t = threading.Thread(target=inverted)
    t.start()
    t.join()
    assert len(errs) == 1
    msg = str(errs[0])
    assert "'A'" in msg and "'B'" in msg and "inversion" in msg


def test_consistent_order_never_raises(mod):
    a, b, c = (mod.WitnessLock(n) for n in "ABC")
    for _ in range(3):
        with a:
            with b:
                with c:
                    pass
    assert ("A", "B") in mod.edges()
    assert ("B", "C") in mod.edges()


def test_reentrant_reacquire_records_no_edge(mod):
    a = mod.WitnessLock("A", reentrant=True)
    with a:
        with a:
            pass
    assert mod.edges() == {}


def test_inversion_detected_single_threaded(mod):
    # both orders in ONE thread still raise — no actual deadlock needed
    a, b = mod.WitnessLock("A"), mod.WitnessLock("B")
    with a:
        with b:
            pass
    with pytest.raises(mod.LockOrderError):
        with b:
            with a:
                pass


def test_release_out_of_order_keeps_stack_sane(mod):
    a, b = mod.WitnessLock("A"), mod.WitnessLock("B")
    a.acquire()
    b.acquire()
    a.release()          # non-LIFO release
    c = mod.WitnessLock("C")
    with c:              # held stack must now be just [B]
        pass
    b.release()
    assert ("B", "C") in mod.edges()
    assert ("A", "C") not in mod.edges()


def test_the_two_graphs_agree_on_one_script():
    """One acquisition script through both packages: the same edges and
    the same inversion message."""
    out = {}
    for name, m in PACKAGES.items():
        a, b, c = (m.WitnessLock(n) for n in "ABC")
        with a:
            with b:
                with c:
                    pass
        with pytest.raises(m.LockOrderError) as e:
            with c:
                with a:
                    pass
        out[name] = (sorted(m.edges()), str(e.value))
    assert out["port"] == out["jax"]
    assert lw.inversions() == [out["port"][1]]


def test_new_lock_plain_without_env(monkeypatch):
    monkeypatch.delenv("TM_LOCK_WITNESS", raising=False)
    lock = lw.new_lock("x")
    assert not isinstance(lock, WitnessLock)
    with lock:
        pass
    assert not isinstance(jlw.new_lock("x"), jlw.WitnessLock)


def test_new_lock_witness_when_enabled(monkeypatch):
    """The JAX case `test_new_lock_witness_with_env` on the port's switch:
    the environment turns the JAX witness on, `enable()` the port's."""
    monkeypatch.setenv("TM_LOCK_WITNESS", "1")
    assert isinstance(jlw.new_lock("x"), jlw.WitnessLock)
    lw.enable()
    lock = lw.new_lock("x")
    assert isinstance(lock, WitnessLock)
    nonreentrant = lw.new_lock("y", reentrant=False)
    assert isinstance(nonreentrant, WitnessLock)
    assert isinstance(nonreentrant._inner, type(threading.Lock()))


def test_env_var_changes_nothing(monkeypatch):
    monkeypatch.setenv("TM_LOCK_WITNESS", "1")
    assert not lw.enabled()
    assert not isinstance(lw.new_lock("x"), WitnessLock)


def test_witness_turns_on_only_by_an_explicit_call():
    assert not lw.enabled()
    with lw.witnessing():
        assert lw.enabled()
        inside = lw.new_lock("inside")
    assert not lw.enabled()
    after = lw.new_lock("after")
    assert isinstance(inside, WitnessLock)
    assert not isinstance(after, WitnessLock)
    # a lock built while on keeps witnessing after the switch is off
    other = WitnessLock("other")
    with other:
        with inside:
            pass
    assert ("other", "inside") in lw.edges()
    lw.enable()
    assert lw.enabled()
    with lw.witnessing():
        pass
    assert lw.enabled()            # the context restores the switch
    lw.disable()
    assert not lw.enabled()


def _wired_locks():
    """The eight wired sites of the port (lock, expected role, expected
    reentrancy)."""
    from types import SimpleNamespace
    from tendermint_tpu_torch.blockchain.pool import BlockPool
    from tendermint_tpu_torch.blockchain.store import BlockStore
    from tendermint_tpu_torch.config import test_config
    from tendermint_tpu_torch.consensus.state import ConsensusState
    from tendermint_tpu_torch.mempool.mempool import Mempool
    from tendermint_tpu_torch.p2p import make_switch
    from tendermint_tpu_torch.proxy import ClientCreator
    from tendermint_tpu_torch.scenarios import fixtures
    from tendermint_tpu_torch.scenarios.engine import EventLog
    from tendermint_tpu_torch.state.state import get_state
    from tendermint_tpu_torch.utils.db import MemDB
    privs, _ = fixtures.make_validators(1)
    conns = ClientCreator("kvstore").new_app_conns()
    plane = SimpleNamespace(backend=None)
    mp = Mempool(conns.mempool, plane=plane)
    cs = ConsensusState(test_config().consensus,
                        get_state(MemDB(), fixtures.make_genesis("c", privs)),
                        conns.consensus, BlockStore(MemDB()), mp, plane)
    sw = make_switch("c", {}, moniker="m")
    return [(cs._mtx, "consensus.mtx", True),
            (BlockPool(1)._lock, "blockpool.lock", False),
            (mp._lock, "mempool.lock", True),
            (sw._peers_lock, "switch.peers", True),
            (sw._threads_lock, "switch.threads", False),
            (sw._ban_lock, "switch.ban", False),
            (sw._rng_lock, "switch.reconnect_rng", False),
            (EventLog()._lock, "scenarios.eventlog", False)]


def test_wired_modules_use_named_roles(monkeypatch):
    with lw.witnessing():
        wired = _wired_locks()
    assert len(wired) == 8
    for lock, role, reentrant in wired:
        assert isinstance(lock, WitnessLock), role
        assert lock.name == role
        rlock = type(threading.RLock())
        assert isinstance(lock._inner, rlock) == reentrant, role
    # the JAX package's sites carry the same role names
    from tendermint_tpu.mempool.mempool import Mempool as JMempool
    monkeypatch.setenv("TM_LOCK_WITNESS", "1")
    assert JMempool(proxy_mempool_conn=None)._lock.name == "mempool.lock"


def test_wired_modules_plain_when_off():
    for lock, role, reentrant in _wired_locks():
        assert not isinstance(lock, WitnessLock), role
        rlock = type(threading.RLock())
        assert isinstance(lock, rlock) == reentrant, role


def test_inversion_through_wired_roles_raises():
    """Two wired roles taken in both orders raise at the second, as they
    would in a run of the node."""
    with lw.witnessing():
        pool_lock = _wired_locks()[1][0]
        mp_lock = _wired_locks()[2][0]
    with mp_lock:
        with pool_lock:
            pass
    with pytest.raises(LockOrderError, match="blockpool.lock"):
        with pool_lock:
            with mp_lock:
                pass
