"""The port's live-rig mechanics (`tests/test_live_rounds.py`'s twins at
the JAX sizes) and the chaos fast-sync (`tests/test_chaos_fastsync.py`'s
twin on the rig ladder), on the CPU backends:

- WireMesh on one plane: commit progress with prefix agreement, an
  island partition that leaves the quorum live, a crash-restart over the
  retained store, and prefix agreement catching a divergent straggler.
  The mesh's validator set and genesis are the JAX mesh's for the seed.
- A 120-block fast-sync through a supervised ladder whose "dev" rung
  raises every 50th call: the synced chain and app hash are the JAX
  fixtures', the breaker trips and recovers, and no peer is blamed.
"""

import time

import numpy as np
import pytest

from tendermint_tpu.scenarios import harness as jharness
from tendermint_tpu_torch.crypto import pure_ed25519 as ref
from tendermint_tpu_torch.crypto.backend import PythonBackend
from tendermint_tpu_torch.crypto.supervised import CLOSED, SupervisedBackend
from tendermint_tpu_torch.p2p import connect_switches
from tendermint_tpu_torch.scenarios import fixtures, harness
from tendermint_tpu_torch.scenarios import invariants as inv
from tendermint_tpu_torch.scenarios.engine import InvariantViolation
from tendermint_tpu_torch.utils.chaos import CryptoChaos
from tendermint_tpu_torch.utils.metrics import REGISTRY

pytestmark = pytest.mark.faults

CHAIN = "live-rig-chain"


def _mesh(n=4, **kw):
    return harness.WireMesh(CHAIN, n, seed=3, backend=PythonBackend(), **kw)


def test_wiremesh_is_the_jax_mesh_for_the_seed():
    mesh = _mesh()
    jmesh = jharness.WireMesh(CHAIN, 4, seed=3)
    assert [p.address for p in mesh.privs] == \
        [p.address for p in jmesh.privs]
    assert mesh.gen.validator_set().hash() == \
        jmesh.gen.validator_set().hash()
    assert len({id(nd.plane) for nd in mesh.nodes}) == 1
    assert all(nd.cs.plane is mesh.plane for nd in mesh.nodes)
    mesh.stop()


def test_wiremesh_commits_with_prefix_agreement():
    mesh = _mesh()
    mesh.start_sampler(poll_s=0.01)
    mesh.start()
    try:
        assert harness.wait_until(lambda: mesh.quorum_height() >= 3,
                                  timeout=60)
        assert harness.wait_until(lambda: len(mesh._samples) >= 3,
                                  timeout=10)
    finally:
        mesh.stop()
    inv.prefix_agreement(mesh.stores())
    assert len(mesh._samples) >= 3
    assert all(g >= 0 for g in mesh.commit_latencies())
    assert mesh.commit_latency_p99() is not None
    # the commit hooks stamped each height at its commit site
    assert mesh.timeline_records()
    assert mesh.gossip_stats()["count"] > 0


def test_wiremesh_island_partition_keeps_quorum_live():
    mesh = _mesh()
    mesh.start()
    try:
        assert harness.wait_until(lambda: mesh.quorum_height() >= 1,
                                  timeout=60)
        mesh.isolate([3])
        h0 = mesh.quorum_height()
        victim_h0 = mesh.nodes[3].block_store.height
        assert harness.wait_until(
            lambda: mesh.quorum_height() >= h0 + 2, timeout=60)
        assert mesh.nodes[3].block_store.height <= victim_h0 + 1
        mesh.heal()
        h1 = mesh.quorum_height()
        assert harness.wait_until(
            lambda: mesh.quorum_height() >= h1 + 1, timeout=60)
    finally:
        mesh.stop()
    inv.prefix_agreement(mesh.stores())


def test_wiremesh_crash_restart_replays_retained_prefix():
    mesh = _mesh()
    mesh.start()
    try:
        assert harness.wait_until(lambda: mesh.quorum_height() >= 2,
                                  timeout=60)
        mesh.crash(1)
        assert 1 not in mesh.live()
        h_store = mesh.nodes[1].block_store.height
        h0 = mesh.quorum_height()
        assert harness.wait_until(
            lambda: mesh.quorum_height() >= h0 + 1, timeout=60)
        mesh.restart(1)
        assert 1 in mesh.live() and mesh.restarts == 1
        nd = mesh.nodes[1]
        assert nd.block_store.height >= h_store
        assert nd.cs.state.last_block_height == nd.block_store.height
        assert nd.cs.plane is mesh.plane
        assert mesh.restart_reports[0]["replay_blocks"] == h_store
        h1 = mesh.quorum_height()
        assert harness.wait_until(
            lambda: mesh.quorum_height() >= h1 + 1, timeout=60)
    finally:
        mesh.stop()
    inv.prefix_agreement(mesh.stores())


def test_prefix_agreement_catches_divergent_straggler():
    mesh = _mesh(n=3)
    mesh.start()
    try:
        assert harness.wait_until(lambda: mesh.quorum_height() >= 2,
                                  timeout=60)
    finally:
        mesh.stop()
    inv.prefix_agreement(mesh.stores())

    class FakeStore:
        height = 1

        def load_block(self, h):
            class B:
                def hash(self):
                    return b"\xde\xad" * 16
            return B()

    with pytest.raises(InvariantViolation, match="prefix divergence"):
        inv.prefix_agreement(mesh.stores() + [FakeStore()])


# -- chaos fast-sync on the rig ladder ---------------------------------------

N_BLOCKS = 120


def test_chaos_fast_sync_completes_without_blaming_peers():
    """Every 50th call of the ladder's "dev" rung raises; the sync
    completes byte-identical to the JAX fixtures' chain with the right
    app hash, the breaker trips and recovers once injection clears, and
    no peer is evicted."""
    from tendermint_tpu.scenarios import fixtures as jfixtures
    privs, vs = fixtures.make_validators(4)
    gen = fixtures.make_genesis(CHAIN, privs)
    hashes = fixtures.kvstore_app_hashes(N_BLOCKS)
    chain = fixtures.build_chain(privs, vs, CHAIN, N_BLOCKS,
                                 app_hashes=hashes)
    jprivs, jvs = jfixtures.make_validators(4)
    jchain = jfixtures.build_chain(jprivs, jvs, CHAIN, N_BLOCKS,
                                   app_hashes=jfixtures.kvstore_app_hashes(
                                       N_BLOCKS))
    assert [b.hash() for b, _, _ in chain] == \
        [b.hash() for b, _, _ in jchain]
    ladder = SupervisedBackend(
        [("dev", PythonBackend()), ("python", PythonBackend())],
        breaker_threshold=1, breaker_cooldown_s=0.2, retries=0,
        call_timeout_s=30.0, chaos=CryptoChaos.parse("raise:every=50"))
    src_sw, _, src_store = harness.fastsync_source(
        CHAIN, chain, gen, backend=PythonBackend())
    sync_sw, bc, cons, sync_store = harness.fastsync_syncer(
        CHAIN, gen, batch_size=2, backend=ladder)
    evicted = []
    orig_evict = bc.pool.on_evict
    bc.pool.on_evict = lambda p, r: (evicted.append((p, r)),
                                     orig_evict and orig_evict(p, r))
    faults0 = REGISTRY.crypto_device_faults.value
    trips0 = REGISTRY.crypto_breaker_trips.value
    recov0 = REGISTRY.crypto_breaker_recoveries.value
    src_sw.start(); sync_sw.start()
    try:
        connect_switches(sync_sw, src_sw)
        deadline = time.time() + 90
        while sync_store.height < N_BLOCKS - 1 and time.time() < deadline:
            if (REGISTRY.crypto_breaker_trips.value > trips0
                    and ladder.chaos.active):
                ladder.chaos.active = False
            time.sleep(0.02)
        assert sync_store.height >= N_BLOCKS - 1, \
            f"synced only to {sync_store.height}: {bc.pool.status()}"
        for h in range(1, N_BLOCKS - 1):
            assert sync_store.load_block(h).hash() == jchain[h - 1][0].hash()
        assert bc.state.app_hash == hashes[N_BLOCKS - 1]
        assert REGISTRY.crypto_device_faults.value > faults0
        assert REGISTRY.crypto_breaker_trips.value > trips0
        seed = bytes(32)
        pub = np.frombuffer(ref.pubkey_from_seed(seed), np.uint8)
        msg = np.zeros(32, np.uint8)
        sig = np.frombuffer(ref.sign(seed, msg.tobytes()), np.uint8)
        deadline = time.time() + 10
        while (REGISTRY.crypto_breaker_recoveries.value == recov0
               and time.time() < deadline):
            ladder.verify_batch(pub[None, :], msg[None, :], sig[None, :])
            time.sleep(0.05)
        assert REGISTRY.crypto_breaker_recoveries.value > recov0
        assert ladder._rungs[0].state == CLOSED
        assert not evicted, f"peer evicted for an injected fault: {evicted}"
        assert sync_sw.misbehavior_score(src_sw.node_info.id) == 0.0
    finally:
        src_sw.stop()
        harness.stop_syncer(sync_sw, cons)
