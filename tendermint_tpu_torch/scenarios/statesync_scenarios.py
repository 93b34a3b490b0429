"""State-sync chaos scenarios: snapshot-join, snapshot-tamper,
snapshot-torn-tail.

The adversary models follow the fast-sync catalogue's deterministic-
finality framing: a snapshot manifest is a finality claim about app
state, so the tamper scenario replays the PoTE stale/forged-proof
attack (arXiv:2512.09409) against the snapshot offer path — a forged
manifest with a lying app_hash, and a peer serving corrupted chunks
under an honest manifest.  The join scenario is the ACE-style rejoin
(arXiv:2603.10242): a node whose disk is gone recovers from a recent
snapshot plus a short verified tail instead of replaying the chain
from genesis.

Copy of `tendermint_tpu/scenarios/statesync_scenarios.py` with the
port's explicit wiring: every snapshot store and syncer hashes its
chunks on `ctx.backend` (kernel K4 on a `CudaBackend` once a batch holds
`snapshot._DEVICE_MIN_CHUNKS` chunks of one length; these snapshots'
smaller batches hash on the host in both packages), the fast-sync rigs
run on it and take their switch seeds from `ctx.chaos`, and the torn
create arms its fail point with `utils.fail.arm(name=)` and clears it,
and the crash callback, in a `finally` (the JAX body sets
`TM_FAIL_POINT` in the environment).
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import tempfile
import time

from tendermint_tpu_torch.abci.app import create_app
from tendermint_tpu_torch.blockchain.store import BlockStore
from tendermint_tpu_torch.p2p.switch import connect_switches, make_switch
from tendermint_tpu_torch.proxy import ClientCreator
from tendermint_tpu_torch.scenarios import fixtures, harness
from tendermint_tpu_torch.scenarios import invariants as inv
from tendermint_tpu_torch.scenarios.engine import register
from tendermint_tpu_torch.state import execution
from tendermint_tpu_torch.state.state import get_state
from tendermint_tpu_torch.statesync.restore import (
    StateSyncer, StoreSource, verify_manifest_app_hash)
from tendermint_tpu_torch.statesync.snapshot import (MANIFEST_NAME,
                                                     SnapshotManifest,
                                                     SnapshotStore)
from tendermint_tpu_torch.utils import fail
from tendermint_tpu_torch.utils.db import MemDB
from tendermint_tpu_torch.utils.metrics import REGISTRY


def _apply_chain(state, conns, store, chain, on_applied=None):
    """Apply every block of `chain` into `state`/`store`; `on_applied`
    (height, state) fires after each block lands — the hook snapshot
    creation and state capture ride on."""
    for block, ps, seen in chain:
        store.save_block(block, ps, seen)
        execution.apply_block(state, conns.consensus, block, ps.header,
                              execution.MockMempool())
        if on_applied is not None:
            on_applied(block.height, state)


def _snapshotting_source(chain_id, chain, gen, snap_store, interval,
                         capture_at=(), *, backend, chaos_seed: int):
    """A served chain whose app state is snapshotted every `interval`
    blocks during the apply (the source-side half of the state-sync
    protocol); its reactor holds `backend`.  Returns (switch, state,
    store, app, captured) where `captured[h]` is (state.encode(),
    app_hash) at height h — the byte-exact parity reference for
    restores."""
    from tendermint_tpu_torch.blockchain.reactor import BlockchainReactor
    state = get_state(MemDB(), gen)
    app = create_app("kvstore")
    conns = ClientCreator(app).new_app_conns()
    store = BlockStore(MemDB())
    captured: dict[int, tuple[bytes, bytes]] = {}

    def hook(height, st):
        if height % interval == 0:
            snap_store.create(st, app.snapshot_state())
        if height in capture_at:
            captured[height] = (st.encode(),
                                app.info().last_block_app_hash)

    _apply_chain(state, conns, store, chain, hook)
    reactor = BlockchainReactor(state, conns.consensus, store,
                                fast_sync=False, backend=backend)
    sw = make_switch(chain_id, {"blockchain": reactor}, moniker="source",
                     chaos_seed=chaos_seed)
    return sw, state, store, app, captured


def _offer_verifier(chain):
    """The light-client cross-check hook built from the scenario's own
    chain: a manifest at height h must match the app_hash committed in
    the (verified) header at h+1."""
    headers = {block.height: block.header for block, _ps, _sc in chain}

    def verify(manifest):
        header = headers.get(manifest.height + 1)
        return (header is not None
                and verify_manifest_app_hash(manifest, header))
    return verify


# ===========================================================================
# snapshot-join (stress)
# ===========================================================================

N_JOIN_BLOCKS = 520
JOIN_INTERVAL = 100       # snapshots at 100..500; retention keeps 400+500
JOIN_TPB = 16             # enough per-block replay work that the full-sync
                          # baseline is dominated by linear replay


def _snapshot_join(ctx):
    chain_id = "chaos-snapshot-join"
    # 6 validators: per-block commit verification is the linear work
    # that makes full replay expensive — exactly the cost the snapshot
    # path's 19-block tail mostly skips
    privs, vs = fixtures.make_validators(6, seed=11)
    gen = fixtures.make_genesis(chain_id, privs)
    hashes = fixtures.kvstore_app_hashes(N_JOIN_BLOCKS,
                                         txs_per_block=JOIN_TPB)
    chain = fixtures.build_chain(privs, vs, chain_id, N_JOIN_BLOCKS,
                                 txs_per_block=JOIN_TPB,
                                 app_hashes=hashes)
    tip = N_JOIN_BLOCKS - 1   # fast-sync stops at tip-1: the last block
    #                           has no successor commit to verify it with
    snap_root = tempfile.mkdtemp(prefix="chaos-snapjoin-")
    ctx.snapshot_metrics("start")
    try:
        snap_store = SnapshotStore(snap_root, chunk_size=16 * 1024,
                                   retain=2, backend=ctx.backend)
        src_sw, _src_state, _src_store, _src_app, _ = \
            _snapshotting_source(chain_id, chain, gen, snap_store,
                                 JOIN_INTERVAL, backend=ctx.backend,
                                 chaos_seed=ctx.chaos.seed)
        snap_heights = [m.height for m in snap_store.list()]
        ctx.note("join.snapshots", heights=snap_heights)

        # -- baseline: the status-quo rejoin — full fast-sync from
        # genesis with every commit verified (the victim's disk is gone;
        # replaying its own blocks is not on the table)
        base_state = get_state(MemDB(), gen)
        base_app = create_app("kvstore")
        base_sw, _bc, base_cons, base_store = harness.fastsync_syncer(
            chain_id, gen, batch_size=16, state=base_state, app=base_app,
            backend=ctx.backend, chaos_seed=ctx.chaos.seed)
        src_sw.start()
        base_sw.start()
        try:
            t0 = time.time()
            connect_switches(base_sw, src_sw)
            baseline_synced = harness.wait_until(
                lambda: base_store.height >= tip, timeout=180,
                poll=0.005)
            baseline_s = max(time.time() - t0, 1e-6)
        finally:
            harness.stop_syncer(base_sw, base_cons)

        # -- victim: restore from the source's snapshots, then fast-sync
        # only the tail snapshot_height -> tip
        syncer = StateSyncer(
            [StoreSource(src_sw.node_info.id, snap_store)],
            verify_offer=_offer_verifier(chain), backend=ctx.backend)
        vic_db = MemDB()
        vic_app = create_app("kvstore")
        t0 = time.time()
        vic_state, manifest = syncer.restore(vic_db, gen, vic_app)
        ctx.snapshot_metrics("restored")
        vic_store = BlockStore(MemDB())
        vic_store.bootstrap(manifest.height)
        vic_sw, _bc2, vic_cons, vic_store = harness.fastsync_syncer(
            chain_id, gen, batch_size=16, state=vic_state,
            store=vic_store, app=vic_app, backend=ctx.backend,
            chaos_seed=ctx.chaos.seed)
        vic_sw.start()
        try:
            connect_switches(vic_sw, src_sw)
            victim_synced = harness.wait_until(
                lambda: vic_store.height >= tip, timeout=180,
                poll=0.005)
            victim_s = max(time.time() - t0, 1e-6)
        finally:
            try:
                harness.stop_syncer(vic_sw, vic_cons)
            finally:
                src_sw.stop()
        tail_blocks = vic_store.height - manifest.height
        REGISTRY.restore_replay_blocks.inc(max(tail_blocks, 0))
        ctx.snapshot_metrics("end")
    finally:
        shutil.rmtree(snap_root, ignore_errors=True)

    base_hash = base_app.info().last_block_app_hash
    vic_hash = vic_app.info().last_block_app_hash
    speedup = baseline_s / victim_s
    ctx.note("join.result", baseline_s=round(baseline_s, 3),
             victim_s=round(victim_s, 3), speedup=round(speedup, 2),
             restore_height=manifest.height, tail_blocks=tail_blocks)
    return {"baseline_synced": baseline_synced,
            "victim_synced": victim_synced,
            "restore_height": manifest.height,
            "tail_blocks": tail_blocks,
            "snap_heights": snap_heights,
            "parity_state": vic_state.encode() == base_state.encode(),
            "parity_app": bool(base_hash) and vic_hash == base_hash,
            "blamed": list(syncer.blamed),
            "budget_metrics": {
                "baseline_fullsync_s": round(baseline_s, 3),
                "victim_catchup_s": round(victim_s, 3),
                "catchup_speedup_x": round(speedup, 2)}}


def _join_safety_parity(ctx, obs):
    inv.require(obs["parity_state"],
                "snapshot-restored state + tail replay is NOT "
                "byte-identical to the full-replay state")
    inv.require(obs["parity_app"],
                "restored app recomputes a different app_hash than the "
                "fully-replayed app")
    inv.require(not obs["blamed"],
                f"honest snapshot source was blamed: {obs['blamed']}")
    # every fetched chunk went through hash verification, none rejected
    inv.metric_increased(ctx, "chunks_verified", until="restored")
    before = ctx.metrics("start") or {}
    after = ctx.metrics("restored") or {}
    inv.require(after.get("chunks_rejected", 0)
                == before.get("chunks_rejected", 0),
                "chunks were rejected on the clean snapshot-join path")


def _join_safety_short_tail(ctx, obs):
    inv.require(obs["restore_height"] >= 500,
                f"restored from height {obs['restore_height']}, below "
                f"the newest snapshot (crash height >= 500)")
    inv.require(0 <= obs["tail_blocks"] <= JOIN_INTERVAL,
                f"victim replayed {obs['tail_blocks']} blocks — more "
                f"than one snapshot interval ({JOIN_INTERVAL})")


def _join_safety_speedup(ctx, obs):
    bm = obs["budget_metrics"]
    inv.require(bm["catchup_speedup_x"] >= 10.0,
                f"snapshot-join is only {bm['catchup_speedup_x']}x "
                f"faster than full replay "
                f"(baseline {bm['baseline_fullsync_s']}s vs victim "
                f"{bm['victim_catchup_s']}s); the bar is 10x")


def _join_liveness(ctx, obs):
    inv.completed(obs, "baseline_synced",
                  "full-replay baseline sync to the tip")
    inv.completed(obs, "victim_synced",
                  "snapshot-restored victim's tail sync to the tip")


register(
    "snapshot-join",
    "a node with no disk rejoins a 520-block chain: restore from the "
    "newest snapshot (height 500, manifest app_hash cross-checked "
    "against a verified header, every chunk hash-verified) then "
    "fast-sync only the tail — byte-identical to a full replay and "
    ">=10x faster than the full fast-sync baseline measured on the "
    "same rig",
    safety=[("restore-parity", _join_safety_parity),
            ("tail-bounded-by-interval", _join_safety_short_tail),
            ("catchup-10x", _join_safety_speedup)],
    liveness=[("both-paths-catch-up", _join_liveness)],
    smoke=False, budget_s=420.0,
    budgets={"victim_catchup_s": {"max": 6.0},
             "baseline_fullsync_s": {"max": 60.0},
             "catchup_speedup_x": {"min": 10.0}})(_snapshot_join)


# ===========================================================================
# snapshot-tamper (stress)
# ===========================================================================

N_TAMPER_BLOCKS = 52
TAMPER_INTERVAL = 16      # snapshots at 16/32/48, retention keeps 32+48
TAMPER_TPB = 6


def _tamper_chunks(rng, snap_store, manifest):
    """Corrupt EVERY chunk of `manifest` in `snap_store` (seed-chosen
    byte, seed-chosen xor).  All of them: the fetcher assigns chunks
    round-robin, so a single bad chunk may legitimately never be asked
    of this peer — tampering all of them makes 'the tamperer served at
    least one bad chunk' deterministic."""
    sdir = snap_store.snapshot_dir(manifest.height)
    for i in range(manifest.chunks):
        path = os.path.join(sdir, f"chunk-{i:06d}.bin")
        with open(path, "rb") as f:
            data = bytearray(f.read())
        pos = rng.randrange(len(data))
        data[pos] ^= rng.randrange(1, 256)
        with open(path, "wb") as f:
            f.write(bytes(data))


def _forge_manifest(src_store, dst_store, honest: SnapshotManifest,
                    height: int) -> None:
    """PoTE-style forged finality claim: reuse the honest snapshot's
    chunks (so the root re-check passes) under a manifest claiming a
    LATER height with a fabricated app_hash.  Internally consistent —
    only the light-client cross-check can catch it."""
    src = src_store.snapshot_dir(honest.height)
    dst = dst_store.snapshot_dir(height)
    os.makedirs(dst, exist_ok=True)
    for name in os.listdir(src):
        if name != MANIFEST_NAME:
            shutil.copy(os.path.join(src, name), os.path.join(dst, name))
    forged = dataclasses.replace(honest, height=height,
                                 app_hash=bytes(range(20)))
    with open(os.path.join(dst, MANIFEST_NAME), "wb") as f:
        f.write(forged.encode_json())


def _snapshot_tamper(ctx):
    chain_id = "chaos-snapshot-tamper"
    privs, vs = fixtures.make_validators(2, seed=13)
    gen = fixtures.make_genesis(chain_id, privs)
    hashes = fixtures.kvstore_app_hashes(N_TAMPER_BLOCKS,
                                         txs_per_block=TAMPER_TPB)
    chain = fixtures.build_chain(privs, vs, chain_id, N_TAMPER_BLOCKS,
                                 txs_per_block=TAMPER_TPB,
                                 app_hashes=hashes)
    rng = ctx.rng("tamper")
    root = tempfile.mkdtemp(prefix="chaos-snaptamper-")
    ctx.snapshot_metrics("start")
    try:
        honest_store = SnapshotStore(os.path.join(root, "honest"),
                                     chunk_size=1024, retain=2,
                                     backend=ctx.backend)
        state = get_state(MemDB(), gen)
        app = create_app("kvstore")
        conns = ClientCreator(app).new_app_conns()
        block_store = BlockStore(MemDB())
        captured: dict[int, tuple[bytes, bytes]] = {}

        def hook(height, st):
            if height % TAMPER_INTERVAL == 0:
                honest_store.create(st, app.snapshot_state())
                captured[height] = (st.encode(),
                                    app.info().last_block_app_hash)

        _apply_chain(state, conns, block_store, chain, hook)
        best = honest_store.best()

        # tamperer: honest manifest, corrupted chunk bytes
        tamper_store = SnapshotStore(os.path.join(root, "tamper"),
                                     chunk_size=1024, retain=2,
                                     backend=ctx.backend)
        shutil.rmtree(tamper_store.root_dir)
        shutil.copytree(honest_store.root_dir, tamper_store.root_dir)
        _tamper_chunks(rng, tamper_store, best)
        # forger: honest chunks, forged manifest at a later height —
        # its higher height makes it the FIRST offer the victim tries
        forge_store = SnapshotStore(os.path.join(root, "forge"),
                                    chunk_size=1024, retain=2,
                                    backend=ctx.backend)
        _forge_manifest(honest_store, forge_store, best, best.height + 2)

        # the victim's switch: bans from statesync blame land here
        sw = make_switch(chain_id, {}, moniker="victim",
                         chaos_seed=ctx.chaos.seed)
        sources = [StoreSource("forger", forge_store),
                   StoreSource("tamperer", tamper_store),
                   StoreSource("honest", honest_store)]
        syncer = StateSyncer(sources,
                             report_misbehavior=sw.report_misbehavior,
                             verify_offer=_offer_verifier(chain),
                             backend=ctx.backend)
        vic_app = create_app("kvstore")
        t0 = time.time()
        vic_state, manifest = syncer.restore(MemDB(), gen, vic_app)
        restore_s = max(time.time() - t0, 1e-6)
        ctx.snapshot_metrics("end")
    finally:
        shutil.rmtree(root, ignore_errors=True)

    ref_state, ref_app_hash = captured[best.height]
    before = ctx.metrics("start") or {}
    after = ctx.metrics("end") or {}
    rejected_delta = (after.get("chunks_rejected", 0)
                      - before.get("chunks_rejected", 0))
    ctx.note("tamper.result", restored_height=manifest.height,
             blamed=list(syncer.blamed), rejected=rejected_delta,
             restore_s=round(restore_s, 3))
    return {"restored": True,
            "restored_height": manifest.height,
            "expected_height": best.height,
            "chunks": manifest.chunks,
            "parity_state": vic_state.encode() == ref_state,
            "parity_app": (bool(ref_app_hash)
                           and vic_app.info().last_block_app_hash
                           == ref_app_hash),
            "blamed": list(syncer.blamed),
            "forger_banned": sw.is_banned("forger"),
            "tamperer_banned": sw.is_banned("tamperer"),
            "honest_banned": sw.is_banned("honest"),
            "rejected_delta": rejected_delta,
            "budget_metrics": {
                "tamper_restore_s": round(restore_s, 3),
                "tamper_chunks_rejected": float(rejected_delta)}}


def _tamper_safety_no_silent_acceptance(ctx, obs):
    # zero silent acceptance: the restore came from the HONEST snapshot
    # (not the forged higher offer), is byte-identical to the state the
    # source snapshotted, and every corrupted chunk that was served got
    # hash-rejected and blamed rather than applied
    inv.require(obs["restored_height"] == obs["expected_height"],
                f"victim restored from height {obs['restored_height']} "
                f"— the forged offer, not the honest snapshot at "
                f"{obs['expected_height']}")
    inv.require(obs["parity_state"] and obs["parity_app"],
                "restored state/app diverges from the snapshotted "
                "source state — corrupted bytes were silently accepted")
    inv.require(obs["rejected_delta"] >= 1,
                "the tamperer's corrupted chunks were never rejected — "
                "hash verification did not fire")
    inv.metric_increased(ctx, "chunks_rejected")
    inv.metric_increased(ctx, "chunks_verified")


def _tamper_safety_blame(ctx, obs):
    inv.require(obs["forger_banned"],
                "the forged-manifest peer was not banned (the "
                "light-client cross-check is a proven lie)")
    inv.require(obs["tamperer_banned"],
                "the chunk-corrupting peer was not banned")
    inv.require(not obs["honest_banned"],
                "the honest snapshot provider was banned")
    blamed_peers = {p for p, _r in obs["blamed"]}
    inv.require("honest" not in blamed_peers,
                f"the honest provider was blamed: {obs['blamed']}")
    inv.require({"forger", "tamperer"} <= blamed_peers,
                f"missing blame entries: {obs['blamed']}")


def _tamper_liveness(ctx, obs):
    inv.completed(obs, "restored",
                  "restore via the good peer after rejecting the "
                  "forged and corrupted offers")


register(
    "snapshot-tamper",
    "PoTE-style snapshot adversaries: a forged manifest claiming a "
    "later height with a fabricated app_hash (caught by the "
    "light-client cross-check) and a peer serving corrupted chunks "
    "under an honest manifest (caught by per-chunk hash verification); "
    "both peers are banned, the restore completes from the honest peer "
    "byte-identically, and not one corrupted byte is accepted",
    safety=[("no-silent-acceptance", _tamper_safety_no_silent_acceptance),
            ("liars-banned-honest-spared", _tamper_safety_blame)],
    liveness=[("restore-completes", _tamper_liveness)],
    smoke=False, budget_s=120.0,
    budgets={"tamper_restore_s": {"max": 30.0},
             "tamper_chunks_rejected": {"min": 1.0}})(_snapshot_tamper)


# ===========================================================================
# snapshot-torn-tail (smoke)
# ===========================================================================

N_TORN_BLOCKS = 12
TORN_INTERVAL = 4


class _CrashMidCreate(Exception):
    """The in-process stand-in for a crash at a snapshot fail point."""


def _snapshot_torn_tail(ctx):
    chain_id = "chaos-snapshot-torn"
    privs, vs = fixtures.make_validators(2, seed=17)
    gen = fixtures.make_genesis(chain_id, privs)
    hashes = fixtures.kvstore_app_hashes(N_TORN_BLOCKS)
    chain = fixtures.build_chain(privs, vs, chain_id, N_TORN_BLOCKS,
                                 app_hashes=hashes)
    rng = ctx.rng("torn")
    # seed-chosen crash site: mid-chunk-write or after the chunks but
    # before the manifest — either way no manifest lands
    crash_site = rng.choice(["Snapshot.chunkWritten",
                             "Snapshot.chunksWritten"])
    ctx.plan("torn.crash", site=crash_site)
    root = tempfile.mkdtemp(prefix="chaos-snaptorn-")
    try:
        store = SnapshotStore(root, chunk_size=512, retain=3,
                              backend=ctx.backend)
        state = get_state(MemDB(), gen)
        app = create_app("kvstore")
        conns = ClientCreator(app).new_app_conns()
        block_store = BlockStore(MemDB())
        captured: dict[int, tuple[bytes, bytes]] = {}
        crashed: list[str] = []

        def hook(height, st):
            if height % TORN_INTERVAL == 0:
                if height == N_TORN_BLOCKS:
                    # crash mid-create of the newest snapshot
                    def boom(name, idx):
                        raise _CrashMidCreate(name)
                    fail.set_callback(boom)
                    fail.arm(name=crash_site)
                    try:
                        store.create(st, app.snapshot_state())
                    except _CrashMidCreate as e:
                        crashed.append(str(e))
                    finally:
                        fail.disarm()
                        fail.set_callback(None)
                else:
                    store.create(st, app.snapshot_state())
            captured[height] = (st.encode(),
                                app.info().last_block_app_hash)

        _apply_chain(state, conns, block_store, chain, hook)

        # bit-rot the previous snapshot's manifest too (seed-chosen
        # truncation): the CRC frame must reject it, leaving only the
        # oldest snapshot intact
        torn_h = N_TORN_BLOCKS - TORN_INTERVAL
        mpath = os.path.join(store.snapshot_dir(torn_h), MANIFEST_NAME)
        raw = open(mpath, "rb").read()
        with open(mpath, "wb") as f:
            f.write(raw[:rng.randrange(1, len(raw))])
        valid, rejects = store.scan()
        valid_heights = [m.height for m in valid]
        reject_reasons = [why for _d, why in rejects]
        ctx.note("torn.scan", valid=valid_heights,
                 rejects=reject_reasons, crashed=crashed)

        # restore from what survived, then replay the short tail
        syncer = StateSyncer([StoreSource("local", store)],
                             verify_offer=_offer_verifier(chain),
                             backend=ctx.backend)
        vic_app = create_app("kvstore")
        vic_state, manifest = syncer.restore(MemDB(), gen, vic_app)
        vic_conns = ClientCreator(vic_app).new_app_conns()
        vic_store = BlockStore(MemDB())
        vic_store.bootstrap(manifest.height)
        for block, ps, _seen in chain[manifest.height:]:
            execution.apply_block(vic_state, vic_conns.consensus, block,
                                  ps.header, execution.MockMempool())
        REGISTRY.restore_replay_blocks.inc(
            N_TORN_BLOCKS - manifest.height)
    finally:
        shutil.rmtree(root, ignore_errors=True)

    ref_state, ref_app_hash = captured[N_TORN_BLOCKS]
    return {"crashed": bool(crashed),
            "crash_site": crash_site,
            "valid_heights": valid_heights,
            "reject_reasons": reject_reasons,
            "restored_height": manifest.height,
            "replayed": N_TORN_BLOCKS - manifest.height,
            "parity_state": vic_state.encode() == ref_state,
            "parity_app": (bool(ref_app_hash)
                           and vic_app.info().last_block_app_hash
                           == ref_app_hash),
            "blamed": list(syncer.blamed)}


def _torn_safety_discard(ctx, obs):
    inv.require(obs["crashed"],
                f"the fail point {obs['crash_site']} never fired — the "
                f"torn-create injection did not happen")
    inv.require(obs["valid_heights"] == [TORN_INTERVAL],
                f"scan kept {obs['valid_heights']} — expected only the "
                f"oldest intact snapshot [{TORN_INTERVAL}] after a torn "
                f"create and a truncated manifest")
    inv.require(len(obs["reject_reasons"]) == 2,
                f"expected 2 rejected snapshots (torn create + "
                f"truncated manifest), got {obs['reject_reasons']}")


def _torn_safety_parity(ctx, obs):
    inv.require(obs["restored_height"] == TORN_INTERVAL,
                f"restored from {obs['restored_height']}, not the "
                f"intact snapshot at {TORN_INTERVAL}")
    inv.require(obs["parity_state"] and obs["parity_app"],
                "restore + tail replay diverges from the source state "
                "at the tip")
    inv.require(not obs["blamed"],
                f"local snapshot store was blamed: {obs['blamed']}")


def _torn_liveness(ctx, obs):
    inv.require(obs["replayed"] == N_TORN_BLOCKS - TORN_INTERVAL,
                f"tail replay covered {obs['replayed']} blocks, "
                f"expected {N_TORN_BLOCKS - TORN_INTERVAL}")
    inv.completed(obs, "parity_state",
                  "recovery from the previous intact snapshot")


register(
    "snapshot-torn-tail",
    "crash mid-snapshot-write (seed-chosen fail point) plus a "
    "bit-rotted manifest: both torn snapshots are discarded on scan "
    "(no manifest / CRC mismatch), recovery restores from the previous "
    "intact snapshot and replays the tail to the tip byte-identically",
    safety=[("torn-snapshots-discarded", _torn_safety_discard),
            ("recovery-parity", _torn_safety_parity)],
    liveness=[("tail-replay-completes", _torn_liveness)],
    smoke=True, budget_s=60.0)(_snapshot_torn_tail)
