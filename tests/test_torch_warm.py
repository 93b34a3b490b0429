"""The port's warm plane held against the JAX package's: `warmcompile`'s
`bench_config3_specs` and `precompile_for_validators`'s shapes equal the
JAX derivations; a comb-table `.npz` the port writes loads in the JAX
`TpuBackend` (its `TM_TABLE_CACHE_DIR`, on the JAX side only) and one the
JAX backend writes loads in the port, with equal arrays; a file with a
wrong digest or a truncated file is a counted miss that K2 rebuilds; the
disk cache evicts its oldest file first past its byte cap; `cli init
--warm-crypto` writes the home's table file on a `cpu` home, which the
home's node then reads without a K2 launch, and prints the JAX message
on a `python` home; the ladder's warm-up raises a rung's fault.  Zero
tolerance: integer and byte data throughout.  The JAX jits run only at
the shape `tests/test_ed25519_grouped.py` compiles (4 keys, Vb 16)."""

import os
from types import SimpleNamespace

import numpy as np
import pytest

from tendermint_tpu.crypto import backend as jcb
from tendermint_tpu.crypto import warmcompile as jwarm
from tendermint_tpu.scenarios import fixtures as jfx
from tendermint_tpu_torch import cli
from tendermint_tpu_torch import config
from tendermint_tpu_torch.crypto import pure_ed25519 as ref
from tendermint_tpu_torch.crypto import warmcompile
from tendermint_tpu_torch.crypto.backend import CudaBackend
from tendermint_tpu_torch.crypto.supervised import SupervisedBackend
from tendermint_tpu_torch.ops import ed25519 as ed
from tendermint_tpu_torch.scenarios import fixtures

from torch_chains import share_cores

SET_KEY = b"disk-set"


def _pubs(tag: int, n: int) -> np.ndarray:
    return np.frombuffer(b"".join(
        ref.pubkey_from_seed(bytes([tag, i + 1]) + b"\x00" * 30)
        for i in range(n)), np.uint8).reshape(n, 32)


@pytest.fixture(scope="module", autouse=True)
def _cores():
    import torch
    old = share_cores()
    yield
    torch.set_num_threads(old)


@pytest.fixture
def k2_calls(monkeypatch):
    """Count the port's K2 calls (the plain version on the CPU)."""
    calls = []
    orig = ed.build_neg_comb

    def counted(pubs):
        calls.append(len(pubs))
        return orig(pubs)

    monkeypatch.setattr(ed, "build_neg_comb", counted)
    return calls


def _file(d) -> str:
    (name,) = os.listdir(d)
    return os.path.join(d, name)


# -- the shapes ---------------------------------------------------------------

@pytest.mark.parametrize("args", [(100, 10_000, 625, 62_500),
                                  (100, 100_000, 0, 62_500),
                                  (4, 24, 8, 1_000), (128, 300, 625, 0)])
def test_bench_config3_specs_match_jax(args):
    mine = warmcompile.bench_config3_specs(*args)
    theirs = jwarm.bench_config3_specs(*args, cache_dir="/unused")
    for s in theirs:
        del s["cache_dir"]          # the XLA cache: no counterpart
    assert mine == theirs


@pytest.mark.parametrize("n_vals", [1, 4, 100])
def test_precompile_shapes_match_jax(n_vals):
    """`precompile_for_validators` derives the same (lanes, templates)
    shapes, set key, keys and message length as the JAX method."""
    privs, vs = jfx.make_validators(n_vals)
    pprivs, pvs = fixtures.make_validators(n_vals)
    got = {}
    for name, fn, vals in (
            ("port", CudaBackend.precompile_for_validators, pvs),
            ("jax", jcb.TpuBackend.precompile_for_validators, vs)):
        rec = []
        fake = SimpleNamespace(precompile=lambda *a, rec=rec: rec.append(a))
        fn(fake, vals)
        (set_key, pubs, shapes, msg_len), = rec
        got[name] = (set_key, pubs.tobytes(), shapes, msg_len)
    assert got["port"] == got["jax"]


def test_precompile_runs_both_routes_at_each_shape(tmp_path, monkeypatch):
    calls = []
    be = CudaBackend(device="cpu", table_cache_dir=str(tmp_path))
    monkeypatch.setattr(be, "verify_grouped", lambda k, p, i, m, s: calls.append(
        ("grouped", len(i), m.shape)))
    monkeypatch.setattr(
        be, "verify_grouped_templated",
        lambda k, p, i, t, tm, s: calls.append(("templated", len(i),
                                                tm.shape)))
    _, vals = fixtures.make_validators(4)
    be.precompile_for_validators(vals)
    assert calls == [("grouped", 16, (16, 128)), ("templated", 16, (1, 128)),
                     ("grouped", 256, (256, 128)),
                     ("templated", 256, (64, 128))]


# -- the on-disk comb-table cache, across the packages ------------------------

def test_table_files_pass_between_the_packages(tmp_path, monkeypatch,
                                               k2_calls):
    pubs = _pubs(7, 4)
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    # the port writes ...
    mine = CudaBackend(device="cpu", table_cache_dir=port_dir)
    tbl, ok, v, _ = mine.tables(SET_KEY, pubs)
    assert k2_calls == [4] and mine.table_disk["writes"] == 1
    path = _file(port_dir)
    assert os.path.basename(path) == f"v1-{SET_KEY.hex()}.npz"
    with np.load(path) as z:
        assert sorted(z.files) == ["ok", "pubs_sha256", "tbl"]
        assert z["tbl"].shape == (26, 1024, 16, 3, 32)
        assert z["tbl"].dtype == np.uint8 and z["ok"].dtype == bool
    want_tbl, want_ok = tbl.numpy(), ok.numpy()
    # ... and the JAX backend loads it (no build: the file is its format);
    # its XLA cache in the checkout's, as the conftest sets it
    monkeypatch.setenv("TM_JAX_CACHE_DIR",
                       os.path.join(os.path.dirname(__file__), ".jax_cache"))
    monkeypatch.setenv("TM_TABLE_CACHE_DIR", port_dir)
    builds = jcb.REGISTRY.table_build_seconds.count
    theirs = jcb.TpuBackend()
    jtbl, jok, jv, _ = theirs._set_tables(SET_KEY, pubs)
    assert jcb.REGISTRY.table_build_seconds.count == builds
    assert jv == v == 4
    assert np.array_equal(np.asarray(jtbl), want_tbl)
    assert np.array_equal(np.asarray(jok), want_ok)
    # the JAX backend builds and writes (its jit at its tests' shape) ...
    monkeypatch.setenv("TM_TABLE_CACHE_DIR", jax_dir)
    jtbl2, jok2, _, _ = jcb.TpuBackend()._set_tables(SET_KEY, pubs)
    assert jcb.REGISTRY.table_build_seconds.count == builds + 1
    assert os.path.basename(_file(jax_dir)) == os.path.basename(path)
    # ... and the port loads that file, with no K2 launch
    again = CudaBackend(device="cpu", table_cache_dir=jax_dir)
    tbl3, ok3, _, _ = again.tables(SET_KEY, pubs)
    assert k2_calls == [4] and again.table_disk["hits"] == 1
    assert again.table_disk["writes"] == 0
    assert np.array_equal(tbl3.numpy(), np.asarray(jtbl2))
    assert np.array_equal(ok3.numpy(), np.asarray(jok2))
    assert np.array_equal(tbl3.numpy(), want_tbl)


@pytest.mark.parametrize("damage", ["digest", "truncated", "garbage",
                                    "shape"])
def test_a_damaged_file_is_a_counted_miss_and_rebuilt(tmp_path, k2_calls,
                                                      damage):
    pubs = _pubs(9, 1)
    d = str(tmp_path / "tables")
    first = CudaBackend(device="cpu", table_cache_dir=d)
    tbl, ok, _, _ = first.tables(SET_KEY, pubs)
    path = _file(d)
    if damage == "digest":
        with np.load(path) as z:
            arrays = {k: z[k] for k in z.files}
        arrays["pubs_sha256"] = arrays["pubs_sha256"] ^ 1
        with open(path, "wb") as f:
            np.savez(f, **arrays)
    elif damage == "shape":
        with np.load(path) as z:
            arrays = {k: z[k] for k in z.files}
        arrays["tbl"] = arrays["tbl"][:, :, :8]
        with open(path, "wb") as f:
            np.savez(f, **arrays)
    elif damage == "truncated":
        raw = open(path, "rb").read()
        open(path, "wb").write(raw[:len(raw) // 2])
    else:
        open(path, "wb").write(b"garbage")
    second = CudaBackend(device="cpu", table_cache_dir=d)
    tbl2, ok2, _, _ = second.tables(SET_KEY, pubs)
    assert second.table_disk == {"hits": 0, "misses": 0, "rejected": 1,
                                 "writes": 1}
    assert k2_calls == [1, 1]                  # rebuilt on K2
    assert np.array_equal(tbl2.numpy(), tbl.numpy())
    assert np.array_equal(ok2.numpy(), ok.numpy())
    # the rewritten file is whole again: a third backend loads it
    third = CudaBackend(device="cpu", table_cache_dir=d)
    third.tables(SET_KEY, pubs)
    assert third.table_disk["hits"] == 1 and k2_calls == [1, 1]


def test_no_cache_dir_means_no_file(tmp_path, k2_calls):
    be = CudaBackend(device="cpu")
    be.tables(SET_KEY, _pubs(3, 1))
    assert be.table_disk == {"hits": 0, "misses": 0, "rejected": 0,
                             "writes": 0}
    assert k2_calls == [1] and os.listdir(tmp_path) == []


def test_eviction_past_the_byte_cap_removes_the_oldest_first(tmp_path):
    d = str(tmp_path / "tables")
    be = CudaBackend(device="cpu", table_cache_dir=d)
    tbl = np.zeros((26, 1024, 1, 3, 32), np.uint8)      # ~2.5 MB a file
    ok = np.ones(1, bool)
    paths = []
    for i in range(3):
        p = be._table_cache_path(bytes([i]) * 8)
        be._write_table_file(p, tbl, ok, bytes(32))
        os.utime(p, (1_000_000 + i, 1_000_000 + i))    # oldest first
        paths.append(p)
    size = os.path.getsize(paths[0])
    be.TABLE_DISK_CACHE_BYTES = 3 * size
    be._prune_table_cache(d)
    assert all(os.path.exists(p) for p in paths)
    be.TABLE_DISK_CACHE_BYTES = 2 * size + size // 2
    p = be._table_cache_path(b"\x09" * 8)
    be._write_table_file(p, tbl, ok, bytes(32))          # 4 files: evict
    left = sorted(os.listdir(d))
    assert os.path.basename(paths[0]) not in left
    assert os.path.basename(paths[1]) not in left
    assert left == sorted(os.path.basename(x) for x in (paths[2], p))
    assert not [n for n in left if n.endswith(".tmp")]


# -- cli init --warm-crypto -----------------------------------------------------

def _home_with_backend(home: str, main, pkg_config, backend: str) -> None:
    assert main(["--home", home, "init", "--chain-id", "warm"]) == 0
    cf = pkg_config.config_file(home)
    c = pkg_config.load_config_file(cf)
    c.base.crypto_backend = backend
    pkg_config.save_config_file(c, cf)


def test_init_warm_crypto_writes_the_tables_the_node_reads(tmp_path, capsys,
                                                           k2_calls):
    from tendermint_tpu_torch.node.node import Node
    from tendermint_tpu_torch.types import GenesisDoc
    home = str(tmp_path / "h")
    _home_with_backend(home, cli.main, config, "cpu")
    capsys.readouterr()
    assert cli.main(["--home", home, "init", "--warm-crypto"]) == 0
    out = capsys.readouterr().out
    assert "warming crypto plane for 1 validators" in out
    assert "crypto warm done in" in out
    cfg = config.load_config_file(config.config_file(home))
    cfg.base.home = home
    d = cfg.base.table_cache_dir()
    assert d == os.path.join(home, "comb_tables")
    vals = GenesisDoc.load(cfg.base.genesis_file()).validator_set()
    path = _file(d)
    assert os.path.basename(path) == f"v1-{vals.set_key().hex()}.npz"
    assert k2_calls == [1]
    # the home's node reads that file on its first verify: no K2
    node = Node(cfg)
    try:
        assert node.backend.table_cache_dir == d
        node.backend.tables(vals.set_key(), vals.pubs_matrix())
        assert node.backend.table_disk["hits"] == 1
        assert k2_calls == [1]
    finally:
        node.stop()


def test_init_warm_crypto_on_a_python_home_prints_the_jax_message(
        tmp_path, capsys):
    from tendermint_tpu import cli as jcli
    from tendermint_tpu import config as jconfig
    lines = {}
    old = jcb._current
    try:
        for name, main, pkg_config in (("port", cli.main, config),
                                       ("jax", jcli.main, jconfig)):
            home = str(tmp_path / name)
            _home_with_backend(home, main, pkg_config, "python")
            capsys.readouterr()
            assert main(["--home", home, "init", "--warm-crypto"]) == 0
            lines[name] = capsys.readouterr().out.splitlines()[-1]
    finally:
        jcb._current = old
    assert lines["port"] == lines["jax"] == (
        "crypto backend 'python' has no device plane; nothing to warm")
    assert not os.path.exists(os.path.join(tmp_path, "port", "comb_tables"))


# -- the ladder ---------------------------------------------------------------

class _Rung:
    name = "cuda"

    def __init__(self, fail: bool):
        self.fail, self.warmed = fail, []

    def precompile_for_validators(self, vals):
        if self.fail:
            raise RuntimeError("kernel launch failed")
        self.warmed.append(vals)


def test_ladder_warms_its_first_warmable_rung_and_raises_its_fault():
    from tendermint_tpu_torch.crypto.backend import PythonBackend
    good = _Rung(False)
    ladder = SupervisedBackend([("cuda", good), ("python", PythonBackend())])
    ladder.precompile_for_validators("vals")
    assert good.warmed == ["vals"]
    bad = SupervisedBackend([("cuda", _Rung(True)),
                             ("python", PythonBackend())])
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        bad.precompile_for_validators("vals")
    # host rungs have nothing to warm
    SupervisedBackend([("python", PythonBackend())]
                      ).precompile_for_validators("vals")


# -- the warmer ---------------------------------------------------------------

def test_warmer_runs_each_spec_kind_on_the_cpu(capsys, monkeypatch):
    """`python -m ...warmcompile` on the plain versions (device "cpu"):
    one JSON line per spec, its digest that of the same inputs through a
    backend of this process."""
    import json
    import sys
    # 2 keys (padded to 16 in the tables): the plain K2 is the cost here
    specs = [{"kind": "templated", "vb": 2, "shape": [16, 1, 128],
              "device": "cpu"},
             {"kind": "plain", "vb": 2, "shape": [16, 128],
              "device": "cpu"},
             {"kind": "sign", "v": 2, "shape": [16, 1, 128],
              "device": "cpu"}]
    monkeypatch.setattr(sys, "argv", ["warmcompile", json.dumps(specs)])
    assert warmcompile.main() == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [ln["kind"] for ln in lines] == ["templated", "plain", "sign"]
    be = CudaBackend(device="cpu")
    for spec, ln in zip(specs, lines):
        assert ln["compile_seconds"] >= ln["launch_seconds"] > 0
        assert warmcompile._warm_one(spec, be)[1] == ln["digest"]
    # the sign spec's signatures are RFC 8032's
    x = warmcompile.spec_inputs(specs[2])
    sigs = be.sign_grouped_templated(x["seeds"], x["val_idx"],
                                     x["tmpl_idx"], x["templates"])
    for i in (0, 1):
        assert sigs[i].tobytes() == ref.sign(
            x["seeds"][x["val_idx"][i]].tobytes(),
            x["templates"][x["tmpl_idx"][i]].tobytes())


def test_prewarm_raises_on_a_failed_warmer():
    import subprocess
    with pytest.raises(subprocess.CalledProcessError):
        warmcompile.prewarm([{"kind": "bogus"}], wait=True)
