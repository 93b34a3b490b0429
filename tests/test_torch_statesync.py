"""The port's state sync (`statesync/`) and the kvstore's snapshot hooks
held against the JAX package's (`tests/test_statesync.py`): the same
chain applied through both kvstores gives byte-equal app blobs, states,
manifests, chunk files and roots; the syncers restore the same states and
blame and ban the same peers for the same reasons, or raise the same
`RestoreError`; the wire messages encode to the same bytes.  Chunk
hashing takes a backend only when given one: `CudaBackend(device="cpu")`
(the plain K4), the native rung and a supervised ladder hash as the host
loop does, and nothing falls back when the backend fails."""

import dataclasses
import json
import os
import shutil

import numpy as np
import pytest
import torch

from tendermint_tpu.abci.app import create_app as jcreate_app
from tendermint_tpu.crypto import backend as jcb
from tendermint_tpu.proxy import ClientCreator as JClientCreator
from tendermint_tpu.state import execution as jexecution
from tendermint_tpu.state.state import get_state as jget_state
from tendermint_tpu.statesync import messages as jsm
from tendermint_tpu.statesync import restore as jrestore
from tendermint_tpu.statesync import snapshot as jsnap
from tendermint_tpu.utils.db import MemDB as JMemDB
from tendermint_tpu_torch.abci.app import Application, create_app
from tendermint_tpu_torch.abci.apps.kvstore import (KVStoreApp,
                                                    PersistentKVStoreApp)
from tendermint_tpu_torch.crypto.backend import CudaBackend, PythonBackend
from tendermint_tpu_torch.crypto.native import NativeBackend
from tendermint_tpu_torch.crypto.supervised import SupervisedBackend
from tendermint_tpu_torch.proxy import ClientCreator
from tendermint_tpu_torch.state import execution
from tendermint_tpu_torch.state.state import get_state
from tendermint_tpu_torch.statesync import messages as sm
from tendermint_tpu_torch.statesync import restore
from tendermint_tpu_torch.statesync import snapshot as snap
from tendermint_tpu_torch.types import merkle
from tendermint_tpu_torch.types.genesis import GenesisDoc
from tendermint_tpu_torch.utils.db import MemDB

from chainutil import (build_chain, kvstore_app_hashes, make_genesis,
                       make_validators)
from torch_chains import port_chain, share_cores


@pytest.fixture(autouse=True, scope="module")
def _share_cores():
    """xdist runs several files at once: this worker's share of the cores
    for torch (several torch pools on the same cores run ~20x slower)."""
    n = share_cores()
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _python_backend():
    old = jcb._current
    jcb.set_backend("python")
    yield
    jcb._current = old


class _Jax:
    snap, restore, messages = jsnap, jrestore, jsm
    MemDB = JMemDB

    @staticmethod
    def app():
        return jcreate_app("kvstore")


class _Port:
    snap, restore, messages = snap, restore, sm
    MemDB = MemDB

    @staticmethod
    def app():
        return create_app("kvstore")


PKGS = {"jax": _Jax, "port": _Port}


@pytest.fixture(scope="module")
def chain():
    """An 8-block kvstore chain (2 txs a block, 2 validators) and its
    genesis, as the JAX package's objects."""
    privs, vs = make_validators(2, seed=3)
    gen = make_genesis("sync-chain", privs)
    jchain = build_chain(privs, vs, "sync-chain", 8, txs_per_block=2,
                         app_hashes=kvstore_app_hashes(8, 2))
    return jchain, gen


def _apply(pkg, chain, on_applied):
    """Apply the chain through `pkg`'s kvstore, calling
    on_applied(height, state, app) after each block."""
    jchain, jgen = chain
    app = pkg.app()
    if pkg is _Jax:
        state = jget_state(JMemDB(), jgen)
        conns = JClientCreator(app).new_app_conns()
        for block, ps, _seen in jchain:
            jexecution.apply_block(state, None, conns.consensus, block,
                                   ps.header, jexecution.MockMempool(),
                                   check_last_commit=False)
            on_applied(block.height, state, app)
    else:
        state = get_state(MemDB(), GenesisDoc.from_json(jgen.to_json()))
        conns = ClientCreator(app).new_app_conns()
        for block, ps, _seen in port_chain(jchain):
            execution.apply_block(state, conns.consensus, block, ps.header,
                                  execution.MockMempool())
            on_applied(block.height, state, app)
    return state, app


def _genesis(pkg, chain):
    jgen = chain[1]
    return jgen if pkg is _Jax else GenesisDoc.from_json(jgen.to_json())


def _tree(root: str) -> dict:
    """Every file under a snapshot root, by relative path."""
    out = {}
    for d, _dirs, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            out[os.path.relpath(p, root)] = open(p, "rb").read()
    return out


def _snapshotted(pkg, chain, root, chunk_size=200, every=3, **kw):
    """Snapshots every `every` heights; returns the store and, per
    snapshot height, (state bytes, app hash, app blob)."""
    store = pkg.snap.SnapshotStore(str(root), chunk_size=chunk_size,
                                   retain=8, **kw)
    captured = {}

    def hook(h, st, app):
        if h % every == 0:
            blob = app.snapshot_state()
            store.create(st, blob)
            captured[h] = (st.encode(), app.info().last_block_app_hash,
                           blob)
    _apply(pkg, chain, hook)
    return store, captured


# -- the snapshot format -------------------------------------------------------

def test_snapshots_byte_identical_to_jax(chain, tmp_path):
    """App blobs, states, manifests, chunk files and roots; retention
    keeps the same heights."""
    got = {}
    for name, pkg in PKGS.items():
        store = pkg.snap.SnapshotStore(str(tmp_path / name), chunk_size=256,
                                       retain=2)
        blobs = []

        def hook(h, st, app, store=store, blobs=blobs):
            if h % 2 == 0:
                blob = app.snapshot_state()
                blobs.append((st.encode(), blob))
                store.create(st, blob)
        _apply(pkg, chain, hook)
        got[name] = (blobs, _tree(store.root_dir),
                     [m.encode_json() for m in store.list()],
                     store.verify(8))
    assert got["port"] == got["jax"]
    assert sorted(got["port"][1]) == sorted(
        f"snapshot-{h:010d}/{f}" for h in (6, 8)
        for f in ["manifest.json"] + [
            n.split("/")[1] for n in got["port"][1]
            if n.startswith(f"snapshot-{h:010d}/chunk")])
    assert got["port"][3]["ok"]


def test_kvstore_restore_state_round_trips(chain):
    _state, app = _apply(_Port, chain, lambda *a: None)
    _jstate, japp = _apply(_Jax, chain, lambda *a: None)
    blob = app.snapshot_state()
    assert blob == japp.snapshot_state()
    fresh = KVStoreApp()
    fresh.restore_state(blob)
    assert fresh.info() == app.info()
    assert fresh.snapshot_state() == blob
    with pytest.raises(ValueError, match="truncated"):
        KVStoreApp().restore_state(blob[:-1])
    assert app.supports_snapshots()
    assert not Application().supports_snapshots()
    with pytest.raises(NotImplementedError):
        Application().snapshot_state()


def test_persistent_kvstore_keeps_its_file(chain, tmp_path):
    path = str(tmp_path / "kv.json")
    _state, app = _apply(_Port, chain, lambda *a: None)
    p = PersistentKVStoreApp(path)
    p.restore_state(app.snapshot_state())
    p.persist_state()
    again = PersistentKVStoreApp(path)
    assert again.info() == app.info()
    assert again.snapshot_state() == app.snapshot_state()
    again.deliver_tx(b"k=v")
    again.commit()
    assert PersistentKVStoreApp(path).info() == again.info()


def test_payload_manifest_codecs_match_jax():
    for pkg in PKGS.values():
        s, a = b"state-bytes", b"app-bytes" * 100
        assert pkg.snap.decode_payload(pkg.snap.encode_payload(s, a)) == \
            (s, a)
        full = pkg.snap.encode_payload(b"state", b"app-state")
        for cut in (0, 2, 6, len(full) - 1):
            with pytest.raises(ValueError):
                pkg.snap.decode_payload(full[:cut])
        with pytest.raises(ValueError):
            pkg.snap.decode_payload(full + b"x")
        assert pkg.snap.split_chunks(b"", 64) == [b""]
        with pytest.raises(ValueError):
            pkg.snap.split_chunks(b"x", 0)
    chunks = [b"aaaa", b"bbbb", b"cc"]
    ms = []
    for pkg in PKGS.values():
        hashes = tuple(pkg.snap.hash_chunks(chunks))
        m = pkg.snap.SnapshotManifest(
            height=7, format=1, chunk_size=4, chunk_hashes=hashes,
            root=merkle.root_from_leaf_hashes(list(hashes)),
            app_hash=b"\x0a" * 20)
        raw = m.encode_json()
        assert pkg.snap.SnapshotManifest.decode_json(raw) == m
        errors = []
        for bad in (raw[:len(raw) // 2],
                    raw.replace(b'"height": 7', b'"height": 8'),
                    json.dumps({**json.loads(raw), "schema": "x/9"}).encode(),
                    dataclasses.replace(m, root=b"\x13" * 32).encode_json()):
            with pytest.raises(ValueError) as e:
                pkg.snap.SnapshotManifest.decode_json(bad)
            errors.append(str(e.value).split(":")[0])
        ms.append((raw, errors, m.key()))
    assert ms[0] == ms[1]


def test_messages_encode_as_jax():
    jm, pm = [], []
    for pkg, out in ((_Jax, jm), (_Port, pm)):
        hashes = (merkle.leaf_hash(b"c"),)
        man = pkg.snap.SnapshotManifest(3, 1, 64, hashes,
                                        merkle.root_from_leaf_hashes(
                                            list(hashes)), b"\x01" * 20)
        M = pkg.messages
        for msg in (M.SnapshotsRequest(), M.SnapshotsResponse((man,)),
                    M.ChunkRequest(3, 0), M.ChunkResponse(3, 0, b"c"),
                    M.NoChunkResponse(3, 1)):
            raw = M.encode_msg(msg)
            assert M.decode_msg(raw) == msg
            out.append(raw)
        with pytest.raises(ValueError):
            M.decode_msg(b"\x09")
    assert pm == jm
    assert sm.STATESYNC_CHANNEL == jsm.STATESYNC_CHANNEL == 0x60


# -- chunk hashing through a backend ---------------------------------------

class _Recorder:
    """A backend's `leaf_hashes`, each call's row count recorded."""

    def __init__(self, inner):
        self.inner, self.rows = inner, []

    def leaf_hashes(self, chunks):
        self.rows.append(len(chunks))
        return self.inner.leaf_hashes(chunks)


def _chunks(n, size=160, tail=37):
    rng = np.random.default_rng(n)
    out = [rng.integers(0, 256, size, dtype=np.uint8).tobytes()
           for _ in range(n)]
    return out + [b"t" * tail] if tail else out


@pytest.mark.parametrize("backend", ["cpu", "native", "ladder"])
def test_hash_chunks_through_a_backend_equals_the_host_loop(backend):
    """The uniform prefix of >= 8 chunks in one `leaf_hashes` call (the
    plain K4, the native library, a ladder's first rung), the tail and
    small batches on the host: the same hashes as the host loop and the
    JAX package."""
    rec = _Recorder(NativeBackend() if backend == "native"
                    else CudaBackend(device="cpu"))
    be = (SupervisedBackend([("cpu", rec), ("python", PythonBackend())])
          if backend == "ladder" else rec)
    for chunks in (_chunks(9), _chunks(8, tail=0), _chunks(7), [b""]):
        want = [merkle.leaf_hash(c) for c in chunks]
        assert snap.hash_chunks(chunks, be) == want == \
            jsnap.hash_chunks(chunks)
    assert rec.rows == [9, 8]


@pytest.mark.parametrize("backend", ["cpu", "native", "ladder"])
def test_hash_chunks_of_mixed_lengths_equal_the_host_loop(backend):
    """A short and a long chunk among the full ones (a faulty peer or
    disk): the full ones still go through the backend in one call, the
    odd ones hash on the host, and every hash is the host loop's."""
    rec = _Recorder(NativeBackend() if backend == "native"
                    else CudaBackend(device="cpu"))
    be = (SupervisedBackend([("cpu", rec), ("python", PythonBackend())])
          if backend == "ladder" else rec)
    chunks = _chunks(12)
    chunks[0], chunks[5] = chunks[0][:-1], chunks[5] + b"x"
    want = [merkle.leaf_hash(c) for c in chunks]
    assert snap.hash_chunks(chunks, be) == want == jsnap.hash_chunks(chunks)
    assert snap.verify_chunk_hashes(dict(enumerate(chunks)), tuple(want),
                                    be) == []
    assert rec.rows == [10, 10]


def test_hash_chunks_takes_no_backend_it_is_not_given():
    assert snap.leaf_hasher(None) is None
    assert snap.leaf_hasher(PythonBackend()) is None
    assert snap.leaf_hasher(SupervisedBackend.build("python")) is None
    chunks = _chunks(12)
    assert snap.hash_chunks(chunks, PythonBackend()) == \
        snap.hash_chunks(chunks)


def test_a_failing_chunk_hash_raises():
    class Broken:
        name = "cuda"

        def leaf_hashes(self, chunks):
            raise RuntimeError("sha256_prefixed: CUDA launch failed")
    with pytest.raises(RuntimeError, match="launch failed"):
        snap.hash_chunks(_chunks(9), Broken())


def test_store_hashes_through_its_backend(chain, tmp_path):
    rec = _Recorder(NativeBackend())
    store, _cap = _snapshotted(_Port, chain, tmp_path / "p", chunk_size=32,
                               backend=rec)
    jstore, _jcap = _snapshotted(_Jax, chain, tmp_path / "j", chunk_size=32)
    assert _tree(store.root_dir) == _tree(jstore.root_dir)
    assert rec.rows and min(rec.rows) >= 8
    n = len(rec.rows)
    assert store.verify(6)["ok"]
    assert len(rec.rows) == n + 1


# -- the store ------------------------------------------------------------------

def test_store_corrupt_missing_torn_and_renamed_as_jax(chain, tmp_path):
    out = {}
    for name, pkg in PKGS.items():
        store, _cap = _snapshotted(pkg, chain, tmp_path / name,
                                   chunk_size=128)
        rep = []
        sdir = store.snapshot_dir(6)
        cpath = os.path.join(sdir, "chunk-000000.bin")
        data = bytearray(open(cpath, "rb").read())
        data[0] ^= 0xFF
        open(cpath, "wb").write(bytes(data))
        rep.append(store.verify(6))
        os.unlink(cpath)
        rep.append(store.verify(6))
        os.unlink(os.path.join(store.snapshot_dir(3), "manifest.json"))
        os.rename(sdir, store.snapshot_dir(5))
        valid, rejects = store.scan()
        rep.append(([m.height for m in valid],
                    [(os.path.basename(d), w) for d, w in rejects]))
        rep.append(store.verify(3))
        out[name] = rep
    assert out["port"] == out["jax"]
    assert not out["port"][0]["ok"] and out["port"][0]["bad_chunks"] == [0]
    assert out["port"][1]["missing_chunks"] == [0]


def _resize_chunks(sdir, index):
    """Chunk `index` one byte short and the next one byte long."""
    for i, grow in ((index, False), (index + 1, True)):
        path = os.path.join(sdir, f"chunk-{i:06d}.bin")
        data = open(path, "rb").read()
        open(path, "wb").write(data + b"x" if grow else data[:-1])


@pytest.mark.parametrize("backend", ["cpu", "native"])
def test_verify_reports_chunks_of_the_wrong_length(backend, chain,
                                                   tmp_path):
    """A chunk file cut short in the middle of a snapshot and its
    neighbour grown: `verify` lists both as bad, as the JAX store does,
    with the full chunks checked through the backend."""
    rec = _Recorder(NativeBackend() if backend == "native"
                    else CudaBackend(device="cpu"))
    out = {}
    for name, pkg in PKGS.items():
        kw = {"backend": rec} if pkg is _Port else {}
        store, _cap = _snapshotted(pkg, chain, tmp_path / name,
                                   chunk_size=48, **kw)
        n = store.load_manifest(6).chunks
        _resize_chunks(store.snapshot_dir(6), n // 2)
        out[name] = store.verify(6)
    assert out["port"] == out["jax"]
    assert out["port"]["bad_chunks"] == [n // 2, n // 2 + 1]
    assert not out["port"]["ok"] and rec.rows[-1] == n - 3


# -- the syncer ------------------------------------------------------------------

def _offer_verifier(chain, pkg):
    headers = {b.header.height: b.header for b, _ps, _sc in
               (chain[0] if pkg is _Jax else port_chain(chain[0]))}
    return lambda m: (headers.get(m.height + 1) is not None and
                      pkg.restore.verify_manifest_app_hash(
                          m, headers[m.height + 1]))


def _tamper_chunks(sdir, first=True):
    for name in os.listdir(sdir):
        if name == "manifest.json":
            continue
        path = os.path.join(sdir, name)
        data = bytearray(open(path, "rb").read())
        data[0 if first else -1] ^= 0x5A
        open(path, "wb").write(bytes(data))


def _scenario(name, pkg, chain, root, backend=None, chunk_size=200):
    """One of `tests/test_statesync.py`'s restore scenarios on `pkg`:
    (restored height, state bytes, app hash, blamed, reports, error)."""
    kw = {} if pkg is _Jax else {"backend": backend}
    store, cap = _snapshotted(pkg, chain, root / "src",
                              chunk_size=chunk_size)
    R = pkg.restore
    src = R.StoreSource("src", store)
    verify = _offer_verifier(chain, pkg)
    gen = _genesis(pkg, chain)
    reports = []

    def report(pid, reason, ban=False):
        reports.append((pid, reason, ban))

    def other(tag):
        s = pkg.snap.SnapshotStore(str(root / tag), chunk_size=chunk_size,
                                   retain=8)
        shutil.copytree(store.root_dir, s.root_dir, dirs_exist_ok=True)
        return s

    if name == "parity":
        syncer = R.StateSyncer([src], verify_offer=verify, **kw)
    elif name == "tampered":
        evil = other("evil")
        _tamper_chunks(evil.snapshot_dir(6))
        syncer = R.StateSyncer([R.StoreSource("evil", evil), src],
                               report_misbehavior=report,
                               verify_offer=verify, **kw)
    elif name == "resized":
        evil = other("evil")
        _resize_chunks(evil.snapshot_dir(6),
                       store.load_manifest(6).chunks // 2)
        syncer = R.StateSyncer([R.StoreSource("evil", evil), src],
                               report_misbehavior=report,
                               verify_offer=verify, **kw)
    elif name == "forged":
        forge = other("forge")
        honest = store.load_manifest(6)
        shutil.copytree(store.snapshot_dir(6), forge.snapshot_dir(7))
        forged = dataclasses.replace(honest, height=7,
                                     app_hash=b"\x77" * 20)
        with open(os.path.join(forge.snapshot_dir(7), "manifest.json"),
                  "wb") as f:
            f.write(forged.encode_json())
        syncer = R.StateSyncer([R.StoreSource("forger", forge), src],
                               report_misbehavior=report,
                               verify_offer=verify, **kw)
    elif name == "exhausted":
        for h in (3, 6):
            _tamper_chunks(store.snapshot_dir(h), first=False)
        syncer = R.StateSyncer([src], report_misbehavior=report, **kw)
    elif name == "stale":
        syncer = R.StateSyncer([src], report_misbehavior=report,
                               verify_offer=lambda m: False, **kw)
    elif name == "wrong_chain":
        privs, _vs = make_validators(2, seed=9)
        jgen = make_genesis("a-different-chain", privs)
        gen = jgen if pkg is _Jax else GenesisDoc.from_json(jgen.to_json())
        syncer = R.StateSyncer([src], report_misbehavior=report, **kw)
    else:                                 # offers: grouping and order
        dup, solo = other("dup"), other("solo")
        solo.delete(6)

        class Broken:
            peer_id = "down"

            def manifests(self):
                raise OSError("unreachable")
        syncer = R.StateSyncer([src, R.StoreSource("dup", dup),
                                R.StoreSource("solo", solo), Broken()], **kw)
        return ([(m.height, [s.peer_id for s in srcs])
                 for m, srcs in syncer.offers()], syncer.blamed)
    app = pkg.app()
    try:
        state, manifest = syncer.restore(pkg.MemDB(), gen, app)
    except R.RestoreError as e:
        return ("RestoreError", str(e), syncer.blamed, reports)
    assert state.encode() == cap[manifest.height][0]
    assert app.snapshot_state() == cap[manifest.height][2]
    return (manifest.height, state.encode(), app.info().last_block_app_hash,
            syncer.blamed, reports)


@pytest.mark.parametrize("name", ["parity", "offers", "tampered", "forged",
                                  "exhausted", "stale", "wrong_chain"])
def test_restore_matches_jax(name, chain, tmp_path):
    """Restored state, app hash, blame list (peer, reason) and reports
    (peer, reason, ban), or the RestoreError, equal to the JAX syncer's."""
    want = _scenario(name, _Jax, chain, tmp_path / "jax")
    got = _scenario(name, _Port, chain, tmp_path / "port")
    assert got == want
    if name == "tampered":
        assert {p for p, _r, _b in got[4]} == {"evil"}
        assert all(b for *_x, b in got[4])
    if name == "forged":
        assert got[0] == 6 and {p for p, _ in got[3]} == {"forger"}
    if name in ("exhausted", "stale", "wrong_chain"):
        assert got[0] == "RestoreError" and got[2]


def test_restore_checks_chunks_on_the_plain_k4(chain, tmp_path):
    """The tampered scenario with each fetch's chunks checked on
    `CudaBackend(device="cpu")` through a recorder: the same blame."""
    rec = _Recorder(CudaBackend(device="cpu"))
    got = _scenario("tampered", _Port, chain, tmp_path / "k4", backend=rec,
                    chunk_size=48)
    want = _scenario("tampered", _Jax, chain, tmp_path / "jax",
                     chunk_size=48)
    assert got == want
    assert rec.rows and min(rec.rows) >= 8


@pytest.mark.parametrize("backend", ["cpu", "native"])
def test_restore_blames_chunks_of_the_wrong_length(backend, chain,
                                                   tmp_path):
    """A source serving a short and a long chunk in the middle of the
    snapshot, its other chunks checked through the backend: blamed and
    banned for the hash mismatch, the honest source serves, and the state
    restores, as the JAX syncer does."""
    rec = _Recorder(NativeBackend() if backend == "native"
                    else CudaBackend(device="cpu"))
    got = _scenario("resized", _Port, chain, tmp_path / "port",
                    backend=rec, chunk_size=48)
    want = _scenario("resized", _Jax, chain, tmp_path / "jax",
                     chunk_size=48)
    assert got == want
    assert got[0] == 6 and {p for p, _r, _b in got[4]} == {"evil"}
    assert all(b for *_x, b in got[4])
    assert rec.rows and min(rec.rows) >= 8
