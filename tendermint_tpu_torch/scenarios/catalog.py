"""The shipped scenario catalogue.

Each scenario composes injectors from `injectors.py` over a rig from
`harness.py`, returns an observations dict, and registers at least one
safety and one liveness invariant.  Smoke scenarios (`smoke=True`) are
the fast subset tier-1 runs on every push; the rest are the
`faults`-marked stress tier (`tests/test_scenarios_slow.py`).

Adversary models for the fast-sync scenarios follow the deterministic-
finality literature: stale finality proofs (PoTE, arXiv:2512.09409) and
partial-commit replay (ACE, arXiv:2603.10242) — a byzantine block
server re-presenting yesterday's commit, or a quorum certificate pruned
below +2/3, for blocks it wants a syncing node to accept.

Copy of `tendermint_tpu/scenarios/catalog.py` with the port's explicit
wiring: every rig runs on `ctx.backend` and takes its switch seeds from
`ctx.chaos`.  The three device scenarios build their own two-rung
ladder, as the JAX ones do, with the chaos spec as the ladder's
`chaos=` and the ladder handed to the rig as its backend (the JAX
scenarios install both process-wide).  Their "dev" rung is a
`CudaBackend` when the run is on the card (`engine.device_rung`), so the
injected raises and flipped lanes land on kernel launches; on the CPU it
is a `PythonBackend`, as in the JAX catalog.
"""

from __future__ import annotations

import os
import tempfile
import threading
import time

import numpy as np

from tendermint_tpu_torch.config import P2PConfig, test_config
from tendermint_tpu_torch.consensus import messages as CM
from tendermint_tpu_torch.consensus.reactor import VOTE_CHANNEL
from tendermint_tpu_torch.consensus.wal import WAL
from tendermint_tpu_torch.crypto.backend import PythonBackend
from tendermint_tpu_torch.crypto.supervised import CLOSED, SupervisedBackend
from tendermint_tpu_torch.p2p import transport
from tendermint_tpu_torch.p2p.peer import Reactor
from tendermint_tpu_torch.p2p.switch import connect_switches, make_switch
from tendermint_tpu_torch.p2p.types import ChannelDescriptor, NetAddress
from tendermint_tpu_torch.scenarios import fixtures, harness, injectors
from tendermint_tpu_torch.scenarios import invariants as inv
from tendermint_tpu_torch.scenarios.engine import device_rung, register
from tendermint_tpu_torch.state.evidence import EvidencePool
from tendermint_tpu_torch.utils import chaos as chaosmod
from tendermint_tpu_torch.utils.db import MemDB
from tendermint_tpu_torch.utils.metrics import REGISTRY


# ===========================================================================
# byz-equivocation (smoke)
# ===========================================================================

def _byz_equivocation(ctx):
    chain_id = "chaos-equivocation"
    target = 4
    nodes, _privs, _gen = harness.wire_net(chain_id, 4, seed=1,
                                           backend=ctx.backend)
    byz = nodes[0]
    heights = injectors.plan_heights(ctx, "equivocation",
                                     1, target + 2, k=3)
    evidence: list = []
    ev_lock = threading.Lock()
    for nd in nodes[1:]:
        nd.cs.evsw.subscribe(
            "scenario", "EvidenceDoubleSign",
            lambda e: (ev_lock.acquire(), evidence.append(e),
                       ev_lock.release()))
    injectors.equivocate(ctx, byz, byz.priv, chain_id, heights)
    for nd in nodes:
        nd.cs.start()
    try:
        nodes[1].mempool.check_tx(b"chaos=equivocation")
        reached = harness.wait_until(
            lambda: all(nd.block_store.height >= target
                        for nd in nodes[1:]), timeout=60)
        captured = harness.wait_until(lambda: bool(evidence),
                                      timeout=20)
    finally:
        harness.stop_wire_net(nodes)
    with ev_lock:
        ev_count = len(evidence)
        ev_ok = all(
            e.vote_a.validator_address == byz.priv.address
            and e.vote_a.block_id.key() != e.vote_b.block_id.key()
            for e in evidence)
    ctx.note("equivocation.result", evidence=ev_count,
             heights=[nd.block_store.height for nd in nodes])
    return {"reached": reached, "captured": captured,
            "evidence_count": ev_count, "evidence_wellformed": ev_ok,
            "honest_heights": [nd.block_store.height for nd in nodes[1:]],
            "_honest_stores": [nd.block_store for nd in nodes[1:]]}


def _equiv_safety_agreement(ctx, obs):
    inv.no_conflicting_commits(obs["_honest_stores"])


def _equiv_safety_evidence(ctx, obs):
    inv.require(obs["captured"] and obs["evidence_count"] >= 1,
                "honest nodes captured no DuplicateVoteEvidence — the "
                "double votes were accepted silently")
    inv.require(obs["evidence_wellformed"],
                "captured evidence does not accuse the byzantine "
                "validator with conflicting block ids")


def _equiv_liveness(ctx, obs):
    inv.completed(obs, "reached",
                  "honest nodes' height progress under equivocation")


register(
    "byz-equivocation",
    "1 of 4 validators double-signs prevotes at seed-chosen heights; "
    "honest nodes must keep committing identical blocks and capture "
    "DuplicateVoteEvidence",
    safety=[("no-conflicting-commits", _equiv_safety_agreement),
            ("equivocation-evidenced", _equiv_safety_evidence)],
    liveness=[("honest-progress", _equiv_liveness)],
    smoke=True, budget_s=120.0)(_byz_equivocation)


# ===========================================================================
# evidence-flood (smoke)
# ===========================================================================

def _evidence_flood(ctx):
    chain_id = "chaos-evflood"
    privs, vs = fixtures.make_validators(4, seed=2)
    pool = EvidencePool(MemDB(), chain_id)
    real, bogus = injectors.fabricate_evidence(
        ctx, privs, vs, chain_id, n_real=6, n_bogus=18)
    # a solo validator keeps committing while the flood lands
    nodes, _, _ = harness.wire_net(chain_id, 1, seed=3,
                                   backend=ctx.backend)
    solo = nodes[0]
    solo.cs.start()
    try:
        h_before = solo.block_store.height
        salvo = ([("real", e) for e in real]
                 + [("bogus", e) for e in bogus])
        ctx.rng("flood-order").shuffle(salvo)
        accepted = {"real": 0, "bogus": 0}
        for kind, e in salvo:
            if pool.add(e, vs):
                accepted[kind] += 1
        flood_done_h = solo.block_store.height
        progressed = harness.wait_until(
            lambda: solo.block_store.height >= flood_done_h + 2,
            timeout=30)
        h_after = solo.block_store.height
    finally:
        harness.stop_wire_net(nodes)
    ctx.note("flood.result", accepted=accepted, pool_size=pool.size())
    return {"accepted_real": accepted["real"],
            "accepted_bogus": accepted["bogus"],
            "pool_size": pool.size(), "n_real": len(real),
            "n_bogus": len(bogus), "progressed": progressed,
            "h_before": h_before, "h_after": h_after}


def _flood_safety(ctx, obs):
    inv.require(obs["accepted_bogus"] == 0,
                f"pool accepted {obs['accepted_bogus']} fabricated "
                f"evidence items — forged proofs were silently believed")
    inv.require(obs["accepted_real"] == obs["n_real"]
                and obs["pool_size"] == obs["n_real"],
                f"pool holds {obs['pool_size']} items, expected exactly "
                f"the {obs['n_real']} real proofs "
                f"(accepted_real={obs['accepted_real']})")


def _flood_liveness(ctx, obs):
    inv.completed(obs, "progressed",
                  "solo validator progress during/after evidence flood")
    inv.height_progressed("solo validator", obs["h_before"],
                          obs["h_after"], min_delta=2)


register(
    "evidence-flood",
    "a pool is flooded with fabricated equivocation proofs (strangers, "
    "agreeing votes, torn signatures) mixed with real ones; only the "
    "real ones may land, and consensus keeps committing",
    safety=[("only-valid-evidence", _flood_safety)],
    liveness=[("commit-progress", _flood_liveness)],
    smoke=True, budget_s=60.0)(_evidence_flood)


# ===========================================================================
# device-rung-walk (smoke)
# ===========================================================================

N_RUNGWALK_BLOCKS = 48


def _device_rung_walk(ctx):
    chain_id = "chaos-rungwalk"
    spec = "raise:every=18"
    ctx.plan("crypto-chaos", spec=spec)
    # the validated config's crypto policy goes to the ladder as chaos=
    chaos = chaosmod.ChaosConfig(seed=ctx.seed, crypto=spec).crypto
    privs, vs = fixtures.make_validators(4, seed=4)
    gen = fixtures.make_genesis(chain_id, privs)
    hashes = fixtures.kvstore_app_hashes(N_RUNGWALK_BLOCKS)
    chain = fixtures.build_chain(privs, vs, chain_id,
                                 N_RUNGWALK_BLOCKS, app_hashes=hashes)
    sup = SupervisedBackend(
        [("dev", device_rung(ctx)), ("python", PythonBackend())],
        breaker_threshold=1, breaker_cooldown_s=0.2,
        retries=0, call_timeout_s=30.0, chaos=chaos)
    src_sw, _, src_store = harness.fastsync_source(
        chain_id, chain, gen, backend=ctx.backend,
        chaos_seed=ctx.chaos.seed)
    sync_sw, bc, _cons, sync_store = harness.fastsync_syncer(
        chain_id, gen, batch_size=2, backend=sup,
        chaos_seed=ctx.chaos.seed)
    evicted: list = []
    orig_evict = bc.pool.on_evict
    bc.pool.on_evict = lambda p, r: (evicted.append(p),
                                     orig_evict and orig_evict(p, r))
    trips0 = REGISTRY.crypto_breaker_trips.value
    recov0 = REGISTRY.crypto_breaker_recoveries.value
    src_sw.start(); sync_sw.start()
    try:
        connect_switches(sync_sw, src_sw)
        deadline = time.time() + 90
        snapped = False
        while (sync_store.height < N_RUNGWALK_BLOCKS - 1
               and time.time() < deadline):
            if (REGISTRY.crypto_breaker_trips.value > trips0
                    and sup.chaos is not None and sup.chaos.active):
                # fault storm "clears" after the first trip; from
                # here the half-open probe must restore the rung
                ctx.snapshot_metrics("faulted")
                snapped = True
                sup.chaos.active = False
                ctx.note("chaos.cleared", mode=sup.chaos.mode)
            time.sleep(0.02)
        if not snapped:
            ctx.snapshot_metrics("faulted")
        synced = sync_store.height >= N_RUNGWALK_BLOCKS - 1
        # drive half-open probes until the breaker recovers
        from tendermint_tpu_torch.crypto import pure_ed25519 as ref
        seed32 = bytes(32)
        pub = np.frombuffer(ref.pubkey_from_seed(seed32), np.uint8)
        msg = np.zeros(32, np.uint8)
        sig = np.frombuffer(ref.sign(seed32, msg.tobytes()), np.uint8)
        deadline = time.time() + 10
        while (REGISTRY.crypto_breaker_recoveries.value == recov0
               and time.time() < deadline):
            sup.verify_batch(pub[None, :], msg[None, :], sig[None, :])
            time.sleep(0.05)
        recovered = (REGISTRY.crypto_breaker_recoveries.value > recov0
                     and sup._rungs[0].state == CLOSED)
        chain_ok = all(
            sync_store.load_block(h).hash()
            == src_store.load_block(h).hash()
            for h in range(1, min(sync_store.height,
                                  N_RUNGWALK_BLOCKS - 2) + 1))
        app_hash_ok = bc.state.app_hash == hashes[-1]
    finally:
        try:
            src_sw.stop()
        finally:
            harness.stop_syncer(sync_sw, _cons)
    status = sup.supervisor_status()
    ctx.note("rungwalk.result", synced_height=sync_store.height,
             recovered=recovered, active_rung=status.get("active_rung"),
             evicted=evicted)
    return {"synced": synced, "recovered": recovered,
            "chain_ok": chain_ok, "app_hash_ok": app_hash_ok,
            "evicted": evicted, "synced_height": sync_store.height}


def _rungwalk_safety(ctx, obs):
    inv.no_silent_acceptance(ctx)
    inv.require(obs["chain_ok"] and obs["app_hash_ok"],
                "synced state diverged from the source under device "
                f"faults (chain_ok={obs['chain_ok']}, "
                f"app_hash_ok={obs['app_hash_ok']})")


def _rungwalk_safety_no_blame(ctx, obs):
    inv.require(not obs["evicted"],
                f"peers evicted for OUR injected device faults: "
                f"{obs['evicted']}")


def _rungwalk_liveness(ctx, obs):
    inv.completed(obs, "synced", "fast-sync under device-fault storm")
    inv.metric_increased(ctx, "blocks_synced")


def _rungwalk_liveness_recovery(ctx, obs):
    inv.metric_increased(ctx, "crypto_breaker_trips")
    inv.require(obs["recovered"],
                "device rung never recovered (breaker stayed open) "
                "after the fault storm cleared")


register(
    "device-rung-walk",
    "sustained device faults during fast-sync force supervised-ladder "
    "demotion; the breaker trips, the sync completes on fallback rungs "
    "with byte-identical state, and the rung recovers once faults clear",
    safety=[("no-silent-acceptance", _rungwalk_safety),
            ("no-peer-blame", _rungwalk_safety_no_blame)],
    liveness=[("sync-completes", _rungwalk_liveness),
              ("rung-recovers", _rungwalk_liveness_recovery)],
    smoke=True, budget_s=180.0)(_device_rung_walk)


# ===========================================================================
# device-wrong-answer (smoke)
# ===========================================================================

def _device_wrong_answer(ctx):
    spec = "wrong:lanes=1,every=3"
    ctx.plan("crypto-chaos", spec=spec)
    sup = SupervisedBackend(
        [("dev", device_rung(ctx)), ("python", PythonBackend())],
        breaker_threshold=3, breaker_cooldown_s=0.1,
        retries=0, call_timeout_s=30.0, spot_check_every=1,
        chaos=chaosmod.ChaosConfig(seed=ctx.seed, crypto=spec).crypto)
    from tendermint_tpu_torch.crypto import pure_ed25519 as ref
    rng = ctx.rng("vectors")
    n_calls = 12
    ctx.plan("verify-calls", n=n_calls)
    wrong = 0
    for i in range(n_calls):
        seed32 = bytes(rng.randrange(256) for _ in range(32))
        msg = bytes(rng.randrange(256) for _ in range(32))
        good = rng.randrange(2) == 0
        sig = ref.sign(seed32, msg)
        if not good:
            sig = sig[:-1] + bytes([sig[-1] ^ 1])
        pub = np.frombuffer(ref.pubkey_from_seed(seed32), np.uint8)
        out = sup.verify_batch(pub[None, :],
                               np.frombuffer(msg, np.uint8)[None, :],
                               np.frombuffer(sig, np.uint8)[None, :])
        if bool(out[0]) != good:
            wrong += 1
    ctx.snapshot_metrics("faulted")
    if sup.chaos is not None:
        sup.chaos.active = False
    # after the storm clears the device rung must serve clean answers
    seed32 = bytes(32)
    msg = bytes(32)
    sig = ref.sign(seed32, msg)
    pub = np.frombuffer(ref.pubkey_from_seed(seed32), np.uint8)
    out = sup.verify_batch(pub[None, :],
                           np.frombuffer(msg, np.uint8)[None, :],
                           np.frombuffer(sig, np.uint8)[None, :])
    cleared_ok = bool(out[0])
    ctx.note("wrong-answer.result", wrong=wrong, cleared_ok=cleared_ok)
    return {"wrong_answers": wrong, "n_calls": n_calls,
            "cleared_ok": cleared_ok}


def _wrong_safety(ctx, obs):
    inv.require(obs["wrong_answers"] == 0,
                f"{obs['wrong_answers']}/{obs['n_calls']} corrupted "
                f"verify answers were ACCEPTED — silent signature "
                f"acceptance")
    # the chaos really corrupted answers and the spot check caught them
    inv.metric_increased(ctx, "crypto_spot_check_mismatches",
                         until="faulted")
    inv.no_silent_acceptance(ctx)


def _wrong_liveness(ctx, obs):
    inv.completed(obs, "cleared_ok",
                  "verify service after wrong-answer storm cleared")


register(
    "device-wrong-answer",
    "a silently-corrupting device flips verify lanes; the per-call spot "
    "check must catch every corruption (DeviceFault, fallback re-serve) "
    "so no wrong answer is ever returned",
    safety=[("no-silent-acceptance", _wrong_safety)],
    liveness=[("service-after-clear", _wrong_liveness)],
    smoke=True, budget_s=30.0)(_device_wrong_answer)


# ===========================================================================
# stale-commit-replay / partial-commit-replay (stress)
# ===========================================================================

N_REPLAY_BLOCKS = 24


def _commit_replay_body(ctx, mode: str):
    chain_id = f"chaos-{mode}-replay"
    privs, vs = fixtures.make_validators(4, seed=5)
    gen = fixtures.make_genesis(chain_id, privs)
    hashes = fixtures.kvstore_app_hashes(N_REPLAY_BLOCKS)
    chain = fixtures.build_chain(privs, vs, chain_id, N_REPLAY_BLOCKS,
                                 app_hashes=hashes)
    heights = injectors.plan_heights(ctx, f"{mode}-heights",
                                     3, N_REPLAY_BLOCKS - 2, k=3)
    seed = ctx.chaos.seed
    byz_sw, _, _ = harness.fastsync_source(chain_id, chain, gen,
                                           moniker="byz",
                                           backend=ctx.backend,
                                           chaos_seed=seed)
    injectors.tamper_block_server(ctx, byz_sw, chain, mode, heights)
    honest_sw, _, honest_store = harness.fastsync_source(
        chain_id, chain, gen, moniker="honest", backend=ctx.backend,
        chaos_seed=seed)
    sync_sw, bc, _cons, sync_store = harness.fastsync_syncer(
        chain_id, gen, batch_size=4, backend=ctx.backend, chaos_seed=seed)
    evicted: list = []
    orig_evict = bc.pool.on_evict
    bc.pool.on_evict = lambda p, r: (evicted.append(p),
                                     orig_evict and orig_evict(p, r))
    for sw in (byz_sw, honest_sw, sync_sw):
        sw.start()
    try:
        t_sync0 = time.time()
        connect_switches(sync_sw, byz_sw)
        connect_switches(sync_sw, honest_sw)
        honest_id = honest_sw.node_info.id
        synced = harness.wait_until(
            lambda: sync_store.height >= N_REPLAY_BLOCKS - 1,
            timeout=60)
        sync_s = max(time.time() - t_sync0, 1e-6)
        chain_ok = all(
            sync_store.load_block(h).hash()
            == honest_store.load_block(h).hash()
            for h in range(1, min(sync_store.height,
                                  N_REPLAY_BLOCKS - 2) + 1))
    finally:
        try:
            byz_sw.stop()
            honest_sw.stop()
        finally:
            harness.stop_syncer(sync_sw, _cons)
    ctx.note("replay.result", mode=mode, synced_height=sync_store.height,
             evicted=[p[:12] for p in evicted])
    return {"synced": synced, "chain_ok": chain_ok,
            "honest_evicted": honest_id in evicted,
            "synced_height": sync_store.height,
            "pool_status": bc.pool.status(),
            "budget_metrics": {
                "sync_blocks_per_sec": round(sync_store.height / sync_s,
                                             3)}}


def _replay_safety(ctx, obs):
    inv.require(obs["chain_ok"],
                "a replayed commit was accepted: synced chain diverges "
                "from the honest chain")


def _replay_safety_blame(ctx, obs):
    inv.require(not obs["honest_evicted"],
                "the honest peer was evicted for the byzantine peer's "
                "replayed commits")


def _replay_liveness(ctx, obs):
    inv.completed(obs, "synced",
                  f"fast-sync past replayed commits "
                  f"(status {obs['pool_status']})")


for _mode, _desc in (
        ("stale", "a byzantine block server splices OLDER seen-commits "
                  "into served blocks (stale finality proofs, PoTE); "
                  "the syncer must reject them, evict the liar, and "
                  "finish byte-identical from the honest peer"),
        ("partial", "a byzantine block server prunes served LastCommits "
                    "below +2/3 (partial-commit replay, ACE); same "
                    "rejection contract, and the honest peer that "
                    "served the preceding block must not be blamed")):
    register(
        f"{_mode}-commit-replay", _desc,
        safety=[("replayed-commit-rejected", _replay_safety),
                ("honest-peer-spared", _replay_safety_blame)],
        liveness=[("sync-completes", _replay_liveness)],
        smoke=False, budget_s=180.0,
        budgets={"sync_blocks_per_sec": {"min": 0.2}})(
            (lambda m: lambda ctx: _commit_replay_body(ctx, m))(_mode))


# ===========================================================================
# partition-heal (stress)
# ===========================================================================

def _partition_heal(ctx):
    chain_id = "chaos-partition"
    window_s = 2.0
    nodes, _privs = harness.reactor_net(chain_id, 4, fuzz=True, seed=6,
                                        backend=ctx.backend,
                                        chaos_seed=ctx.chaos.seed)
    victim_i = ctx.rng("partition").randrange(4)
    ctx.plan("partition", victim=victim_i, window_s=window_s,
             direction="inbound")
    victim = nodes[victim_i]
    others = [nd for i, nd in enumerate(nodes) if i != victim_i]
    try:
        nodes[0].mempool.check_tx(b"chaos=partition")
        pre_ok = harness.wait_until(
            lambda: all(nd.block_store.height >= 2 for nd in nodes),
            timeout=60)
        h_victim0 = victim.block_store.height
        # one-directional: the victim goes deaf (its reads stall) but
        # keeps speaking — the asymmetric-fuzz partition shape
        injectors.sever_inbound(ctx, victim.fuzz_links(), stall=1.0,
                                label=f"node{victim_i}")
        time.sleep(window_s)
        h_others_mid = max(nd.block_store.height for nd in others)
        injectors.restore(ctx, victim.fuzz_links(),
                          label=f"node{victim_i}")
        t_heal0 = time.time()
        healed = harness.wait_until(
            lambda: victim.block_store.height >= h_others_mid + 1,
            timeout=90)
        heal_lag_s = time.time() - t_heal0
        quorum_ok = harness.wait_until(
            lambda: max(nd.block_store.height
                        for nd in others) > h_others_mid,
            timeout=60)
        h_victim1 = victim.block_store.height
    finally:
        harness.stop_reactor_net(nodes)
    ctx.note("partition.result", pre_ok=pre_ok, healed=healed,
             heights=[nd.block_store.height for nd in nodes])
    return {"pre_ok": pre_ok, "healed": healed, "quorum_ok": quorum_ok,
            "h_victim_before_heal": h_victim0,
            "h_victim_after_heal": h_victim1,
            "_stores": [nd.block_store for nd in nodes],
            "budget_metrics": {"victim_heal_lag_s": round(heal_lag_s, 3)}}


def _partition_safety(ctx, obs):
    inv.no_conflicting_commits(obs["_stores"])


def _partition_liveness(ctx, obs):
    inv.completed(obs, "pre_ok", "pre-partition convergence")
    inv.completed(obs, "quorum_ok",
                  "quorum progress during/after the partition")
    inv.completed(obs, "healed", "victim catch-up after heal")
    inv.height_progressed("partitioned node", obs["h_victim_before_heal"],
                          obs["h_victim_after_heal"], min_delta=1)


register(
    "partition-heal",
    "a seed-chosen node is partitioned one-directionally (deaf, still "
    "speaking) via asymmetric fuzz profiles; the 3-node quorum keeps "
    "committing, and after heal the victim catches up with no "
    "conflicting commits",
    safety=[("no-conflicting-commits", _partition_safety)],
    liveness=[("heal-and-catch-up", _partition_liveness)],
    smoke=False, budget_s=240.0,
    budgets={"victim_heal_lag_s": {"max": 60.0}})(_partition_heal)


# ===========================================================================
# crash-restart-storm (stress)
# ===========================================================================

def _crash_restart_storm(ctx):
    chain_id = "chaos-crashstorm"
    rng = ctx.rng("crash")
    deltas = [rng.randrange(2, 5) for _ in range(2)]
    ctx.plan("crash-schedule", deltas=deltas)
    home = tempfile.mkdtemp(prefix="chaos-crash-")
    wal_path = os.path.join(home, "data", "cs.wal")
    prefix_hashes: dict[int, bytes] = {}
    stable = True
    target = 0
    for cycle, delta in enumerate(deltas):
        target += delta
        node = harness.solo_node(home, chain_id, backend=ctx.backend)
        node.start()
        try:
            reached = harness.wait_until(
                lambda: node.block_store.height >= target, timeout=60)
            if reached:
                # read the committed prefix while the node is live
                # (stop() may close the sqlite stores)
                for h in range(1, target + 1):
                    bh = node.block_store.load_block(h).hash()
                    if h in prefix_hashes and prefix_hashes[h] != bh:
                        stable = False
                    prefix_hashes[h] = bh
            height_now = node.block_store.height
        finally:
            node.stop()
        if not reached:
            ctx.note("crash.stall", cycle=cycle, target=target,
                     height=height_now)
            return {"progressed": False, "prefix_stable": stable,
                    "final_height": height_now, "last_target": target}
        injectors.tear_wal_tail(ctx, wal_path, rng)
        ctx.note("crash.cycle", cycle=cycle, height=target)
    # final restart: must replay past the torn tail and keep going
    node = harness.solo_node(home, chain_id, backend=ctx.backend)
    node.start()
    t_restart0 = time.time()
    try:
        progressed = harness.wait_until(
            lambda: node.block_store.height >= target + 2, timeout=60)
        post_restart_s = time.time() - t_restart0
        final_height = node.block_store.height
        for h in range(1, target + 1):
            if prefix_hashes[h] != node.block_store.load_block(h).hash():
                stable = False
    finally:
        node.stop()
    report = WAL.fsck(wal_path)
    ctx.note("crash.final", final_height=final_height,
             fsck_records=report["records"],
             tail_garbage=bool(report["tail_garbage"]))
    return {"progressed": progressed, "prefix_stable": stable,
            "final_height": final_height, "last_target": target,
            "wal_records": report["records"],
            "budget_metrics": {
                "post_restart_progress_s": round(post_restart_s, 3)}}


def _crash_safety(ctx, obs):
    inv.require(obs["prefix_stable"],
                "a restart rewrote an already-committed block — the "
                "chain prefix changed across crash cycles")


def _crash_liveness(ctx, obs):
    inv.completed(obs, "progressed",
                  f"height progress after the crash storm (reached "
                  f"{obs['final_height']}, needed "
                  f"{obs['last_target'] + 2})")


register(
    "crash-restart-storm",
    "SIGKILL-style teardown mid-WAL-write (torn frames appended at "
    "seed-chosen heights), twice; every restart must replay past the "
    "torn tail, never rewrite a committed block, and keep committing",
    safety=[("committed-prefix-stable", _crash_safety)],
    liveness=[("progress-after-restarts", _crash_liveness)],
    smoke=False, budget_s=300.0,
    budgets={"post_restart_progress_s": {"max": 45.0}})(_crash_restart_storm)


# ===========================================================================
# combined-adversary scenarios (stress): multiple concurrently-running
# injectors with seed-derived phase offsets, via ctx.schedule()
# ===========================================================================

def _tcp_source_p2p():
    """P2PConfig for a dialable fast-sync source: a real TCP listener on
    an ephemeral port, so the syncer can dial it as a PERSISTENT peer
    and the self-healing reconnect path (jittered backoff after a
    partition-induced eviction) is in play."""
    p2p = test_config().p2p
    p2p.laddr = "tcp://127.0.0.1:0"
    # WAN-ish bandwidth: at 512KB/s a whole test chain lands in the
    # pool's 75-deep request window within ~100ms and a mid-sync
    # partition has nothing left to starve.  20KB/s keeps requests
    # outstanding for seconds (blocks are ~2.6KB) while staying 2x above
    # the pool's 10KB/s starvation floor during healthy flow.
    p2p.send_rate = 20_480
    return p2p


def _sever_window(ctx, sync_sw, peer_id: str, window_s: float,
                  stall: float, label: str) -> None:
    """Asymmetric partition of ONE link for `window_s`: every read the
    syncer does on its link to `peer_id` stalls.  The profile is
    re-applied every 50ms because the self-healing reconnect path keeps
    establishing FRESH links (new FuzzedConnection, clean profile) —
    a partition severs the path, not one connection object."""
    ctx.note("partition.sever", label=label, window_s=window_s)
    deadline = time.time() + window_s
    while time.time() < deadline:
        link = harness.fuzz_link_to(sync_sw, peer_id)
        if link is not None:
            link.set_profile(read_drop_prob=1.0, read_stall=stall)
        time.sleep(0.05)
    link = harness.fuzz_link_to(sync_sw, peer_id)
    if link is not None:
        link.set_profile(read_drop_prob=0.0)
    ctx.note("partition.heal", label=label)


# ---------------------------------------------------------------------------
# device-storm-partition
# ---------------------------------------------------------------------------

N_STORM_BLOCKS = 32
N_STORM_VALIDATORS = 12


def _device_storm_partition(ctx):
    chain_id = "chaos-storm-partition"
    spec = "raise:every=6"
    ctx.plan("crypto-chaos", spec=spec)
    chaos = chaosmod.ChaosConfig(seed=ctx.seed, crypto=spec).crypto
    privs, vs = fixtures.make_validators(N_STORM_VALIDATORS, seed=8)
    gen = fixtures.make_genesis(chain_id, privs)
    hashes = fixtures.kvstore_app_hashes(N_STORM_BLOCKS)
    chain = fixtures.build_chain(privs, vs, chain_id, N_STORM_BLOCKS,
                                 app_hashes=hashes)
    sup = SupervisedBackend(
        [("dev", device_rung(ctx)), ("python", PythonBackend())],
        breaker_threshold=1, breaker_cooldown_s=0.2,
        retries=0, call_timeout_s=30.0, chaos=chaos)
    src_sw, _, src_store = harness.fastsync_source(
        chain_id, chain, gen, moniker="source",
        config=_tcp_source_p2p(), backend=ctx.backend,
        chaos_seed=ctx.chaos.seed)
    sync_sw, bc, _cons, sync_store = harness.fastsync_syncer(
        chain_id, gen, batch_size=4, fuzz=True, backend=sup,
        chaos_seed=ctx.chaos.seed)
    trips0 = REGISTRY.crypto_breaker_trips.value
    src_sw.start(); sync_sw.start()
    src_id = src_sw.node_info.id
    # the window must outlast the pool's 3s request timeout, and the
    # stall must outlast the window, or reads merely slow down and
    # no eviction (hence no reconnect) ever fires
    window_s = 4.5
    ctx.plan("partition-window", window_s=window_s)
    try:
        sync_sw.dial_peer_async(
            NetAddress.parse(str(src_sw._listener.addr)),
            persistent=True)
        connected = harness.wait_until(
            lambda: sync_sw.get_peer(src_id) is not None, timeout=15)

        def partition():
            # sever only after blocks flowed, so the stall is a real
            # mid-sync partition (and the pool's starvation eviction
            # can fire against a peer that HAS delivered)
            harness.wait_until(lambda: sync_store.height >= 4,
                               timeout=30)
            _sever_window(ctx, sync_sw, src_id, window_s, 6.0,
                          "syncer<-source")

        def storm_clear():
            # the device-fault storm clears only after it provably
            # hit (first breaker trip), like a real transient fault
            harness.wait_until(
                lambda: REGISTRY.crypto_breaker_trips.value > trips0,
                timeout=45)
            if sup.chaos is not None:
                sup.chaos.active = False
            ctx.note("chaos.cleared")

        sched = ctx.schedule("storm")
        sched.add("partition", partition, after=0.2, jitter_s=0.5)
        sched.add("device-storm-clear", storm_clear, after=0.5,
                  jitter_s=1.0)
        sched.run(join_timeout_s=90.0)
        t_sync0 = time.time()
        synced = harness.wait_until(
            lambda: sync_store.height >= N_STORM_BLOCKS - 1,
            timeout=120)
        sync_s = max(time.time() - t_sync0, 1e-6)
        chain_ok = all(
            sync_store.load_block(h).hash()
            == src_store.load_block(h).hash()
            for h in range(1, min(sync_store.height,
                                  N_STORM_BLOCKS - 2) + 1))
        src_banned = sync_sw.is_banned(src_id)
        src_score = sync_sw.misbehavior_score(src_id)
    finally:
        try:
            src_sw.stop()
        finally:
            harness.stop_syncer(sync_sw, _cons)
    ctx.note("storm-partition.result", synced_height=sync_store.height,
             src_banned=src_banned, src_score=src_score)
    return {"connected": connected, "synced": synced, "chain_ok": chain_ok,
            "src_banned": src_banned, "src_score": src_score,
            "synced_height": sync_store.height,
            "budget_metrics": {
                "sync_blocks_per_sec": round(sync_store.height / sync_s, 3)}}


def _storm_safety(ctx, obs):
    inv.no_silent_acceptance(ctx)
    inv.require(obs["chain_ok"],
                "synced chain diverged from the source under the "
                "combined device-fault + partition storm")


def _storm_safety_no_blame(ctx, obs):
    inv.require(not obs["src_banned"] and obs["src_score"] == 0.0,
                f"the honest source was blamed for OUR injected faults "
                f"(banned={obs['src_banned']}, score={obs['src_score']}) "
                f"— partitions and device faults must never score a peer")


def _storm_liveness(ctx, obs):
    inv.completed(obs, "connected", "initial persistent dial")
    inv.completed(obs, "synced",
                  "fast-sync through the device storm + partition")
    inv.metric_increased(ctx, "blocks_synced")


def _storm_liveness_evidence(ctx, obs):
    inv.metric_increased(ctx, "crypto_breaker_trips")
    inv.metric_increased(ctx, "switch_reconnect_attempts")


register(
    "device-storm-partition",
    "12-validator fast-sync under a COMBINED adversary: a device-fault "
    "storm (breaker trips to fallback rungs) concurrent with an "
    "asymmetric partition of the source link; the evicted source heals "
    "via jittered persistent reconnect and the sync finishes "
    "byte-identical with the source unblamed",
    safety=[("no-silent-acceptance", _storm_safety),
            ("no-peer-blame", _storm_safety_no_blame)],
    liveness=[("sync-completes", _storm_liveness),
              ("storm-and-heal-evidenced", _storm_liveness_evidence)],
    smoke=False, budget_s=240.0,
    budgets={"sync_blocks_per_sec": {"min": 0.1}})(_device_storm_partition)


# ---------------------------------------------------------------------------
# equivocation-crash-restart
# ---------------------------------------------------------------------------

N_ECR_VALIDATORS = 10

# a 10-node net on pure-python crypto needs ~1s of GIL-shared verify
# work per height; the test_config 20-100ms windows would burn every
# height on round timeouts
ECR_TIMEOUTS = {"timeout_propose": 3.0, "timeout_propose_delta": 1.0,
                "timeout_prevote": 1.5, "timeout_prevote_delta": 0.5,
                "timeout_precommit": 1.5, "timeout_precommit_delta": 0.5}


def _equivocation_crash_restart(ctx):
    chain_id = "chaos-equiv-crash"
    # autostart=False: the equivocation hook and evidence watchers
    # must install before height 1, or a fast net blows past the
    # scheduled double-sign heights unobserved
    nodes, privs = harness.reactor_net(chain_id, N_ECR_VALIDATORS,
                                       seed=7, timeouts=ECR_TIMEOUTS,
                                       autostart=False, backend=ctx.backend,
                                       chaos_seed=ctx.chaos.seed)
    gen = nodes[0].gen
    byz = nodes[0]
    victim_i = 1 + ctx.rng("victim").randrange(N_ECR_VALIDATORS - 1)
    ctx.plan("crash-victim", index=victim_i)
    heights = injectors.plan_heights(ctx, "equivocation", 2, 6, k=2)
    evidence: list = []
    ev_lock = threading.Lock()
    watchers = [i for i in range(1, N_ECR_VALIDATORS)
                if i != victim_i][:2]
    for i in watchers:
        nodes[i].cs.evsw.subscribe(
            "scenario", "EvidenceDoubleSign",
            lambda e: (ev_lock.acquire(), evidence.append(e),
                       ev_lock.release()))
    # in reactor nets votes travel only via the per-peer gossip
    # routines, which pull from the node's own vote sets — a
    # conflicting vote is rejected from the set and never gossiped.
    # The injector must push it onto the wire itself.
    injectors.equivocate(
        ctx, byz, privs[0], chain_id, heights,
        broadcast=lambda msg: byz.switch.broadcast(
            VOTE_CHANNEL, CM.encode_msg(msg)))
    harness.start_reactor_net(nodes, stagger_s=0.02)
    holder = {"victim": nodes[victim_i]}
    crashed = threading.Event()
    quorum = [nd for i, nd in enumerate(nodes)
              if i not in (0, victim_i)]
    try:
        nodes[1].mempool.check_tx(b"chaos=equiv-crash")
        pre_ok = harness.wait_until(
            lambda: all(nd.block_store.height >= 2 for nd in nodes),
            timeout=180)
        h_mid = max(nd.block_store.height for nd in quorum)

        def crash():
            ctx.note("crash.stop", index=victim_i,
                     height=holder["victim"].block_store.height)
            holder["victim"].stop()
            crashed.set()

        def restart():
            # the offsets order restart after crash; the event makes
            # the ordering hard even under scheduler skew
            crashed.wait(timeout=60)
            node2 = harness.ReactorNode(
                privs[victim_i], gen, chain_id, f"node{victim_i}-r",
                cfg=harness.config_with_timeouts(ECR_TIMEOUTS),
                plane=nodes[0].plane, chaos_seed=ctx.chaos.seed)
            node2.start()
            for i, nd in enumerate(nodes):
                if i != victim_i:
                    connect_switches(node2.switch, nd.switch)
            holder["victim"] = node2
            ctx.note("crash.restarted", index=victim_i)

        sched = ctx.schedule("crash-restart")
        sched.add("crash", crash, after=0.1, jitter_s=0.5)
        sched.add("restart", restart, after=1.5, jitter_s=1.0)
        sched.run(join_timeout_s=120.0)
        progressed = harness.wait_until(
            lambda: max(nd.block_store.height
                        for nd in quorum) >= h_mid + 2, timeout=180)
        h_quorum = max(nd.block_store.height for nd in quorum)
        # the restarted validator rebuilt from GENESIS: catching up
        # to the quorum proves consensus catchup gossip serves the
        # whole committed prefix to a from-scratch joiner
        t_catchup0 = time.time()
        caught_up = harness.wait_until(
            lambda: holder["victim"].block_store.height >= h_quorum,
            timeout=180)
        catchup_s = time.time() - t_catchup0
        captured = harness.wait_until(lambda: bool(evidence),
                                      timeout=30)
    finally:
        harness.stop_reactor_net(
            [nd for i, nd in enumerate(nodes) if i != victim_i]
            + [holder["victim"]])
    with ev_lock:
        ev_count = len(evidence)
        ev_ok = all(
            e.vote_a.validator_address == privs[0].address
            and e.vote_a.block_id.key() != e.vote_b.block_id.key()
            for e in evidence)
    ctx.note("equiv-crash.result", pre_ok=pre_ok, progressed=progressed,
             caught_up=caught_up, evidence=ev_count,
             victim_height=holder["victim"].block_store.height)
    return {"pre_ok": pre_ok, "progressed": progressed,
            "caught_up": caught_up, "captured": captured,
            "evidence_count": ev_count, "evidence_wellformed": ev_ok,
            "victim_height": holder["victim"].block_store.height,
            "quorum_height": h_quorum,
            "budget_metrics": {"victim_catchup_s": round(catchup_s, 3)},
            "_stores": ([nd.block_store for nd in quorum]
                        + [holder["victim"].block_store])}


def _ecr_safety_agreement(ctx, obs):
    inv.no_conflicting_commits(obs["_stores"])


def _ecr_safety_evidence(ctx, obs):
    inv.require(obs["captured"] and obs["evidence_count"] >= 1,
                "no DuplicateVoteEvidence captured — the equivocation "
                "ran unobserved through the crash-restart storm")
    inv.require(obs["evidence_wellformed"],
                "captured evidence does not accuse the byzantine "
                "validator with conflicting block ids")


def _ecr_liveness(ctx, obs):
    inv.completed(obs, "pre_ok", "pre-crash convergence of all 10 nodes")
    inv.completed(obs, "progressed",
                  "quorum progress while the victim was down and the "
                  "byzantine node kept double-signing")


def _ecr_liveness_catchup(ctx, obs):
    inv.completed(
        obs, "caught_up",
        f"restarted-from-genesis validator catch-up (victim at "
        f"{obs['victim_height']}, quorum at {obs['quorum_height']})")


register(
    "equivocation-crash-restart",
    "10-validator reactor net under a COMBINED adversary: one validator "
    "double-signs at seed-chosen heights while another crashes and is "
    "rebuilt from genesis mid-equivocation; the quorum keeps committing "
    "identical blocks, captures the evidence, and the restarted node "
    "catches up over catchup gossip",
    safety=[("no-conflicting-commits", _ecr_safety_agreement),
            ("equivocation-evidenced", _ecr_safety_evidence)],
    liveness=[("quorum-progress", _ecr_liveness),
              ("restart-catch-up", _ecr_liveness_catchup)],
    smoke=False, budget_s=420.0,
    budgets={"victim_catchup_s": {"max": 150.0}})(_equivocation_crash_restart)


# ---------------------------------------------------------------------------
# stale-replay-partition
# ---------------------------------------------------------------------------

N_SRP_BLOCKS = 24
N_SRP_VALIDATORS = 12


def _stale_replay_partition(ctx):
    chain_id = "chaos-stale-partition"
    privs, vs = fixtures.make_validators(N_SRP_VALIDATORS, seed=9)
    gen = fixtures.make_genesis(chain_id, privs)
    hashes = fixtures.kvstore_app_hashes(N_SRP_BLOCKS)
    chain = fixtures.build_chain(privs, vs, chain_id, N_SRP_BLOCKS,
                                 app_hashes=hashes)
    # a contiguous stale band guarantees the byzantine server gets
    # asked for at least one tampered height no matter how the pool
    # splits the request window between the two sources
    h0 = 8 + ctx.rng("stale-band").randrange(N_SRP_BLOCKS - 14)
    band = list(range(h0, h0 + 4))
    seed = ctx.chaos.seed
    byz_sw, _, _ = harness.fastsync_source(chain_id, chain, gen,
                                           moniker="byz",
                                           backend=ctx.backend,
                                           chaos_seed=seed)
    injectors.tamper_block_server(ctx, byz_sw, chain, "stale", band)
    honest_sw, _, honest_store = harness.fastsync_source(
        chain_id, chain, gen, moniker="honest",
        config=_tcp_source_p2p(), backend=ctx.backend, chaos_seed=seed)
    sync_sw, bc, _cons, sync_store = harness.fastsync_syncer(
        chain_id, gen, batch_size=4, fuzz=True, backend=ctx.backend,
        chaos_seed=seed)
    evicted: list = []
    orig_evict = bc.pool.on_evict
    bc.pool.on_evict = lambda p, r: (evicted.append((p, r)),
                                     orig_evict and orig_evict(p, r))
    for sw in (byz_sw, honest_sw, sync_sw):
        sw.start()
    honest_id = honest_sw.node_info.id
    byz_id = byz_sw.node_info.id
    # outlast the pool's 3s request timeout so the honest peer is
    # provably evicted-then-reconnected (see _sever_window)
    window_s = 4.5
    ctx.plan("partition-window", window_s=window_s)
    try:
        connect_switches(sync_sw, byz_sw)
        sync_sw.dial_peer_async(
            NetAddress.parse(str(honest_sw._listener.addr)),
            persistent=True)
        connected = harness.wait_until(
            lambda: sync_sw.get_peer(honest_id) is not None,
            timeout=15)

        def partition():
            # engage before verification reaches the stale band, so
            # the redo path has to ride out the honest-link blackout
            harness.wait_until(lambda: sync_store.height >= 3,
                               timeout=30)
            _sever_window(ctx, sync_sw, honest_id, window_s, 6.0,
                          "syncer<-honest")

        def delay_byz():
            link = harness.fuzz_link_to(sync_sw, byz_id)
            if link is not None:
                injectors.delay_storm(ctx, [link], delay_prob=0.3,
                                      max_delay=0.03, label="byz-link")

        sched = ctx.schedule("stale-partition")
        sched.add("sever-honest", partition, after=0.2, jitter_s=0.4)
        sched.add("delay-byz", delay_byz, after=0.1, jitter_s=0.3)
        sched.run(join_timeout_s=90.0)
        t_sync0 = time.time()
        synced = harness.wait_until(
            lambda: sync_store.height >= N_SRP_BLOCKS - 1, timeout=120)
        sync_s = max(time.time() - t_sync0, 1e-6)
        chain_ok = all(
            sync_store.load_block(h).hash()
            == honest_store.load_block(h).hash()
            for h in range(1, min(sync_store.height,
                                  N_SRP_BLOCKS - 2) + 1))
        byz_banned = sync_sw.is_banned(byz_id)
        honest_banned = sync_sw.is_banned(honest_id)
        honest_score = sync_sw.misbehavior_score(honest_id)
    finally:
        try:
            byz_sw.stop()
            honest_sw.stop()
        finally:
            harness.stop_syncer(sync_sw, _cons)
    byz_bad_block = any(p == byz_id and r.startswith("bad block")
                        for p, r in evicted)
    ctx.note("stale-partition.result", synced_height=sync_store.height,
             byz_banned=byz_banned, honest_banned=honest_banned,
             evicted=[(p[:12], r) for p, r in evicted])
    return {"connected": connected, "synced": synced, "chain_ok": chain_ok,
            "byz_banned": byz_banned, "byz_bad_block": byz_bad_block,
            "honest_banned": honest_banned, "honest_score": honest_score,
            "synced_height": sync_store.height,
            "budget_metrics": {
                "sync_blocks_per_sec": round(sync_store.height / sync_s, 3)}}


def _srp_safety(ctx, obs):
    inv.require(obs["chain_ok"],
                "a stale replayed commit was accepted behind the "
                "partition: synced chain diverges from the honest chain")
    inv.require(obs["byz_bad_block"] and obs["byz_banned"],
                f"the stale-replay server was not banned "
                f"(bad_block_evicted={obs['byz_bad_block']}, "
                f"banned={obs['byz_banned']}) — a proven commit lie must "
                f"ban immediately")


def _srp_safety_no_blame(ctx, obs):
    inv.require(not obs["honest_banned"] and obs["honest_score"] == 0.0,
                f"the honest source was blamed for partition-induced "
                f"timeouts (banned={obs['honest_banned']}, "
                f"score={obs['honest_score']}) — slow is not malicious")


def _srp_liveness(ctx, obs):
    inv.completed(obs, "connected", "initial persistent dial")
    inv.completed(obs, "synced",
                  "fast-sync past the stale band and the partition")
    inv.metric_increased(ctx, "blocks_synced")


def _srp_liveness_heal(ctx, obs):
    inv.metric_increased(ctx, "switch_reconnect_attempts")
    inv.metric_increased(ctx, "switch_peers_evicted")


register(
    "stale-replay-partition",
    "12-validator fast-sync under a COMBINED adversary: a byzantine "
    "server replays a band of stale commits while an asymmetric "
    "partition blacks out the honest link and a delay storm jitters the "
    "byzantine one; the liar is banned on the first proven bad block, "
    "the timeout-evicted honest peer reconnects unblamed, and the sync "
    "finishes byte-identical",
    safety=[("stale-band-rejected-liar-banned", _srp_safety),
            ("honest-peer-spared", _srp_safety_no_blame)],
    liveness=[("sync-completes", _srp_liveness),
              ("self-healing-evidenced", _srp_liveness_heal)],
    smoke=False, budget_s=240.0,
    budgets={"sync_blocks_per_sec": {"min": 0.1}})(_stale_replay_partition)


# ---------------------------------------------------------------------------
# partition-heal-25
# ---------------------------------------------------------------------------

N_HEAL_NODES = 25
N_HEAL_VICTIMS = 5
HEAL_BAN_WINDOW_S = 3.0


class _MeshProbeReactor(Reactor):
    """One-channel probe reactor for the p2p-layer rig: counts received
    probes so a post-heal broadcast proves the reconnected mesh carries
    traffic, not just registry entries."""

    CH = 0x70

    def __init__(self):
        super().__init__()
        self.probes = 0
        self._lock = threading.Lock()

    def get_channels(self):
        return [ChannelDescriptor(id=self.CH)]

    def receive(self, ch_id, peer, msg):
        with self._lock:
            self.probes += 1


def _heal_p2p_config() -> P2PConfig:
    # short backoff so the 25-node storm rides through several jittered
    # attempts inside the scenario budget; ban window likewise compressed
    return P2PConfig(laddr="tcp://127.0.0.1:0", pex=False,
                     max_num_peers=N_HEAL_NODES - 1,
                     dial_timeout_s=2.0,
                     reconnect_max_attempts=60,
                     reconnect_backoff_base_s=0.5,
                     reconnect_backoff_max_s=2.0,
                     misbehavior_ban_window_s=HEAL_BAN_WINDOW_S)


def _partition_heal_25(ctx):
    """p2p-layer partition-heal at 25 validators: a seed-chosen minority
    is cut off (listeners down, cross links severed); the persistent
    dialers on the majority side must heal the full mesh through
    jittered exponential backoff without ever overshooting
    max_num_peers, and a peer banned for misbehavior mid-run must stay
    out for the whole window before rejoining."""
    rng = ctx.rng("heal25")
    victims = sorted(rng.sample(range(N_HEAL_NODES), N_HEAL_VICTIMS))
    survivors = [i for i in range(N_HEAL_NODES) if i not in victims]
    liar, reporter = rng.sample(survivors, 2)
    window_s = 4.0
    ctx.plan("partition", victims=victims, window_s=window_s)
    ctx.plan("misbehavior", liar=liar, reporter=reporter,
             ban_window_s=HEAL_BAN_WINDOW_S)

    reactors = [_MeshProbeReactor() for _ in range(N_HEAL_NODES)]
    switches = [make_switch("chaos-heal25", {"probe": reactors[i]},
                            _heal_p2p_config(), moniker=f"node{i}",
                            chaos_seed=ctx.chaos.seed)
                for i in range(N_HEAL_NODES)]
    overshoot = {"max": 0}
    stop_sampling = threading.Event()

    def sample():
        while not stop_sampling.is_set():
            m = max(sw.n_peers() for sw in switches)
            if m > overshoot["max"]:
                overshoot["max"] = m
            time.sleep(0.02)

    def dialer_of(i: int, j: int) -> int:
        # cross-cut edges dial FROM the survivor side, so a severed
        # minority models a true partition (nobody inside it can dial
        # out); the liar->reporter edge is dialed by the liar so its
        # post-ban redials exercise the refused-while-banned path
        iv, jv = i in victims, j in victims
        if iv != jv:
            return j if iv else i
        if {i, j} == {liar, reporter}:
            return liar
        return min(i, j)

    try:
        for sw in switches:
            sw.start()
            time.sleep(0.01)            # staggered bring-up
        addrs = [sw._listener.addr for sw in switches]
        ids = [sw.node_info.id for sw in switches]
        threading.Thread(target=sample, daemon=True,
                         name="heal25-sampler").start()
        for i in range(N_HEAL_NODES):
            for j in range(i + 1, N_HEAL_NODES):
                d = dialer_of(i, j)
                other = j if d == i else i
                switches[d].dial_peer_async(addrs[other], persistent=True)
        meshed = harness.wait_until(
            lambda: all(sw.n_peers() == N_HEAL_NODES - 1
                        for sw in switches), timeout=90)
        ctx.note("heal25.meshed", ok=meshed)

        victim_ids = {ids[v] for v in victims}
        ports = {v: addrs[v].port for v in victims}
        severed = threading.Event()

        def sever():
            for v in victims:
                switches[v]._listener.close()
            for s in survivors:
                for p in switches[s].peers():
                    if p.id in victim_ids:
                        p.mconn.conn.close()
            severed.set()
            ctx.note("heal25.severed", victims=victims)

        def heal():
            # offsets order heal after sever; the event makes the
            # ordering hard even under scheduler skew
            severed.wait(timeout=30)
            time.sleep(window_s)
            for v in victims:
                # the accept routine re-reads _listener every loop, so
                # swapping in a fresh listener on the same port reopens
                # the victim to the survivors' backoff dialers
                switches[v]._listener = transport.Listener(
                    NetAddress("tcp", "127.0.0.1", ports[v]))
            ctx.note("heal25.healed")

        sched = ctx.schedule("partition-heal")
        sched.add("sever", sever, after=0.1, jitter_s=0.2)
        sched.add("heal", heal, after=0.2, jitter_s=0.2)
        sched.run(join_timeout_s=60.0)

        t_heal0 = time.time()
        reconverged = harness.wait_until(
            lambda: all(sw.n_peers() == N_HEAL_NODES - 1
                        for sw in switches), timeout=120)
        reconverge_s = time.time() - t_heal0
        if not reconverged:
            ctx.note("heal25.stragglers",
                     peer_counts=[sw.n_peers() for sw in switches])
        probe_reach = len(switches[reporter].broadcast(
            _MeshProbeReactor.CH, b"heal-probe"))
        probe_rcvd = harness.wait_until(
            lambda: sum(r.probes for r in reactors) >= N_HEAL_NODES - 1,
            timeout=15)

        rep = switches[reporter]
        liar_id = ids[liar]
        crossed = rep.report_misbehavior(
            liar_id, "scenario: proven commit lie", ban=True)
        time.sleep(1.2)
        ban_held = rep.is_banned(liar_id) and rep.get_peer(liar_id) is None
        if not ban_held:
            ctx.note("heal25.ban-leak",
                     is_banned=rep.is_banned(liar_id),
                     liar_registered=rep.get_peer(liar_id) is not None,
                     reporter_peers=rep.n_peers())
        restored = harness.wait_until(
            lambda: rep.get_peer(liar_id) is not None, timeout=30)
        unbanned = not rep.is_banned(liar_id)
    finally:
        stop_sampling.set()
        for sw in switches:
            sw.stop()
    ctx.note("heal25.result", meshed=meshed, reconverged=reconverged,
             overshoot_max=overshoot["max"], probe_reach=probe_reach,
             ban_held=ban_held, restored=restored)
    return {"meshed": meshed, "reconverged": reconverged,
            "overshoot_max": overshoot["max"],
            "probe_reach": probe_reach, "probe_rcvd": probe_rcvd,
            "crossed": crossed, "ban_held": ban_held,
            "restored": restored, "unbanned": unbanned,
            "budget_metrics": {
                "mesh_reconverge_s": round(reconverge_s, 3)}}


def _heal25_safety_cap(ctx, obs):
    inv.require(obs["overshoot_max"] <= N_HEAL_NODES - 1,
                f"peer count overshot max_num_peers during the heal "
                f"storm (max seen {obs['overshoot_max']} > "
                f"{N_HEAL_NODES - 1})")


def _heal25_safety_ban(ctx, obs):
    inv.require(obs["crossed"],
                "ban=True misbehavior report did not cross the ban line")
    inv.require(obs["ban_held"],
                "a banned misbehaving peer was re-admitted (or never "
                "evicted) inside its ban window")


def _heal25_liveness(ctx, obs):
    inv.completed(obs, "meshed", "initial 25-node full mesh")
    inv.completed(obs, "reconverged",
                  "post-heal reconvergence to the full mesh")
    inv.require(obs["probe_reach"] == N_HEAL_NODES - 1
                and obs["probe_rcvd"],
                f"post-heal broadcast reached {obs['probe_reach']}/"
                f"{N_HEAL_NODES - 1} peers — reconnected entries exist "
                f"but the mesh is not carrying traffic")
    inv.metric_increased(ctx, "switch_reconnect_attempts")


def _heal25_liveness_ban_expiry(ctx, obs):
    inv.completed(obs, "restored",
                  "banned peer rejoining after its window expired")
    inv.require(obs["unbanned"],
                "ban did not self-expire after its configured window")
    inv.metric_increased(ctx, "switch_peers_evicted")


register(
    "partition-heal-25",
    "p2p self-healing at scale: a 25-validator TCP mesh loses a "
    "seed-chosen 5-node minority (listeners down, links cut); jittered "
    "persistent-reconnect backoff heals the full mesh with no peer-count "
    "overshoot past max_num_peers, and a peer banned for misbehavior "
    "stays out for the whole window before rejoining",
    safety=[("no-peer-overshoot", _heal25_safety_cap),
            ("ban-holds-for-window", _heal25_safety_ban)],
    liveness=[("mesh-reconverges", _heal25_liveness),
              ("ban-expires-and-rejoins", _heal25_liveness_ban_expiry)],
    smoke=False, budget_s=300.0,
    budgets={"mesh_reconverge_s": {"max": 100.0}})(_partition_heal_25)


SMOKE_ORDER = ["device-wrong-answer", "evidence-flood",
               "byz-equivocation", "device-rung-walk",
               "snapshot-torn-tail", "batchplane-isolation",
               "eviction-storm"]
