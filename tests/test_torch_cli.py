"""The port's CLI (`tendermint_tpu_torch.cli`) in process on tmp homes,
held against the JAX package's: the files `init` and `testnet` write read
back into equal configs, genesis and priv-validator files are
byte-compatible both ways, `wal-fsck` and `replay` agree with the JAX
commands on a port node's home, and the WebSocket frames of `rpc/
websocket` are byte-equal with the JAX module's."""

import io
import json
import os
import subprocess
import sys
import time

import pytest

from tendermint_tpu import __version__ as jversion
from tendermint_tpu import cli as jcli
from tendermint_tpu import config as jconfig
from tendermint_tpu.rpc import websocket as jws
from tendermint_tpu.types import (GenesisDoc as JGenesisDoc,
                                  PrivValidator as JPrivValidator)
from tendermint_tpu_torch import __version__
from tendermint_tpu_torch import cli
from tendermint_tpu_torch import config
from tendermint_tpu_torch.node.node import Node
from tendermint_tpu_torch.rpc import websocket as ws
from tendermint_tpu_torch.types import GenesisDoc, PrivValidator

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _sections(cfg) -> dict:
    return {sec: dict(vars(getattr(cfg, sec))) for sec in config._SECTIONS}


def test_init_config_reads_into_jax_and_back(tmp_path, capsys):
    home = str(tmp_path / "h")
    assert cli.main(["--home", home, "init", "--chain-id", "c1"]) == 0
    for f in ("genesis.json", "priv_validator.json", "config.toml"):
        assert os.path.exists(os.path.join(home, f))
    assert GenesisDoc.load(os.path.join(home, "genesis.json")).chain_id == \
        "c1"
    cf = config.config_file(home)
    mine = config.load_config_file(cf)
    theirs = jconfig.load_config_file(cf)
    assert _sections(mine) == _sections(theirs)
    assert mine.base.crypto_backend == "cuda" and mine.base.home == home
    # a JAX home's file into the port's config
    jhome = str(tmp_path / "j")
    assert jcli.main(["--home", jhome, "init", "--chain-id", "c1"]) == 0
    jcf = jconfig.config_file(jhome)
    assert _sections(config.load_config_file(jcf)) == _sections(
        jconfig.load_config_file(jcf))
    bogus = tmp_path / "bogus.toml"
    bogus.write_text("[base]\nbogus = 1\n")
    with pytest.raises(ValueError, match="unknown config key"):
        config.load_config_file(str(bogus))


def test_save_config_file_is_byte_equal_with_jax(tmp_path):
    cfg, jcfg = config.Config(), jconfig.Config()
    cfg.base.crypto_backend = jcfg.base.crypto_backend = "python"
    cfg.base.home = jcfg.base.home = "/x"
    cfg.p2p.persistent_peers = jcfg.p2p.persistent_peers = ['a"b:1', "c"]
    config.save_config_file(cfg, str(tmp_path / "a.toml"))
    jconfig.save_config_file(jcfg, str(tmp_path / "b.toml"))
    assert (tmp_path / "a.toml").read_bytes() == \
        (tmp_path / "b.toml").read_bytes()


def test_testnet_homes_match_jax(tmp_path, capsys):
    args = ["--n", "4", "--chain-id", "tn", "--base-port", "28900"]
    assert cli.main(["testnet", "--output", str(tmp_path / "p"), *args]) == 0
    assert jcli.main(["testnet", "--output", str(tmp_path / "j"), *args]) == 0
    pvs = []
    for i in range(4):
        p, j = (str(tmp_path / d / f"node{i}") for d in ("p", "j"))
        mine = _sections(config.load_config_file(config.config_file(p)))
        theirs = _sections(jconfig.load_config_file(config.config_file(j)))
        for s in (mine, theirs):
            s["base"].pop("home")
            s["base"].pop("crypto_backend")
        assert mine == theirs
        assert mine["p2p"]["persistent_peers"] == (
            ["127.0.0.1:28900"] if i else [])
        assert mine["p2p"]["laddr"] == f"tcp://0.0.0.0:{28900 + 2 * i}"
        pvs.append(PrivValidator.load(os.path.join(p, "priv_validator.json")))
        gen = JGenesisDoc.load(os.path.join(p, "genesis.json"))
        assert [v.pub_key for v in gen.validators] == [
            pv.pub_key.bytes_ for pv in pvs[:i + 1]] + [
            v.pub_key for v in gen.validators[i + 1:]]


def test_genesis_and_priv_validator_files_byte_compatible(tmp_path):
    home = str(tmp_path / "h")
    cli.main(["--home", home, "init"])
    for name, mine, theirs in (
            ("genesis.json", GenesisDoc, JGenesisDoc),
            ("priv_validator.json", PrivValidator, JPrivValidator)):
        src = os.path.join(home, name)
        raw = open(src, "rb").read()
        out = str(tmp_path / ("j-" + name))
        if name == "genesis.json":
            theirs.load(src).save(out)
        else:
            jpv = theirs.load(src)
            jpv.file_path = out
            jpv.save()
        assert open(out, "rb").read() == raw
        back = str(tmp_path / ("p-" + name))
        if name == "genesis.json":
            mine.load(out).save(back)
        else:
            pv = mine.load(out)
            pv.file_path = back
            pv.save()
        assert open(back, "rb").read() == raw


def test_gen_show_validator_and_version(tmp_path, capsys):
    assert cli.main(["gen_validator"]) == 0
    g = json.loads(capsys.readouterr().out)
    assert set(g) == {"address", "pub_key", "priv_key"}
    home = str(tmp_path / "h")
    cli.main(["--home", home, "init"])
    capsys.readouterr()
    assert cli.main(["--home", home, "show_validator"]) == 0
    shown = json.loads(capsys.readouterr().out)
    pv = PrivValidator.load(os.path.join(home, "priv_validator.json"))
    assert shown == {"address": pv.address.hex(),
                     "pub_key": pv.pub_key.bytes_.hex()}
    assert jcli.main(["--home", home, "show_validator"]) == 0
    assert json.loads(capsys.readouterr().out) == shown
    assert cli.main(["version"]) == 0
    assert capsys.readouterr().out.strip() == __version__ == jversion


def test_home_defaults_to_the_port_home_and_ignores_tm_home(
        tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.setenv("TM_HOME", str(tmp_path / "elsewhere"))
    assert cli.main(["init"]) == 0
    assert os.path.exists(tmp_path / ".tendermint_tpu_torch" / "genesis.json")
    assert not os.path.exists(tmp_path / "elsewhere")


def test_unsafe_reset_all(tmp_path, capsys):
    home = str(tmp_path / "h")
    cli.main(["--home", home, "init"])
    os.makedirs(os.path.join(home, "data"))
    pv_file = os.path.join(home, "priv_validator.json")
    pv = PrivValidator.load(pv_file)
    pv.last_height, pv.last_round = 7, 2
    pv.save()
    assert cli.main(["--home", home, "unsafe_reset_all"]) == 0
    assert not os.path.exists(os.path.join(home, "data"))
    pv = PrivValidator.load(pv_file)
    assert (pv.last_height, pv.last_round) == (0, 0)


@pytest.fixture(scope="module")
def ran_home(tmp_path_factory):
    """A home a port node ran on (SQLite stores, its WAL): init, then a
    node in process on the golden verifier with fast timeouts, stopped
    after a few blocks with txs."""
    home = str(tmp_path_factory.mktemp("ran") / "h")
    cli.main(["--home", home, "init", "--chain-id", "ran"])
    cfg = config.load_config_file(config.config_file(home))
    fast = config.test_config()
    cfg.consensus = fast.consensus
    cfg.base.home = home
    cfg.base.crypto_backend = "python"
    cfg.rpc.laddr = cfg.p2p.laddr = ""
    n = Node(cfg)
    n.start()
    try:
        for i in range(6):
            n.mempool.check_tx(b"k%d=v%d" % (i, i))
        t0 = time.monotonic()
        while n.block_store.height < 6 and time.monotonic() - t0 < 30:
            time.sleep(0.01)
    finally:
        n.stop()
    assert n.block_store.height >= 6
    return home, n.state.app_hash


def test_wal_fsck_agrees_with_jax(ran_home, capsys, tmp_path):
    home, _ = ran_home
    wal = os.path.join(home, "data", "cs.wal")
    assert cli.main(["--home", home, "wal-fsck"]) == 0
    out = capsys.readouterr().out
    assert "clean" in out
    assert jcli.main(["--home", home, "wal-fsck"]) == 0
    assert capsys.readouterr().out == out
    bad = str(tmp_path / "bad.wal")
    data = bytearray(open(wal, "rb").read())
    data[len(data) // 2] ^= 0xFF
    open(bad, "wb").write(data)
    jbad = str(tmp_path / "jbad.wal")
    open(jbad, "wb").write(data)
    rc = cli.main(["--home", home, "wal-fsck", "--wal", bad])
    mine = capsys.readouterr().out
    jrc = jcli.main(["--home", home, "wal-fsck", "--wal", jbad])
    theirs = capsys.readouterr().out
    assert rc == jrc == 1 and mine.replace(bad, "W") == \
        theirs.replace(jbad, "W")
    assert cli.main(["--home", home, "wal-fsck", "--wal", bad,
                     "--repair"]) == 0
    assert open(bad, "rb").read() != bytes(data)
    assert cli.main(["--home", home, "wal-fsck", "--wal", bad]) == 0


def test_replay_and_replay_console(ran_home, capsys, monkeypatch):
    home, app_hash = ran_home
    assert cli.main(["--home", home, "replay"]) == 0
    out = capsys.readouterr().out
    assert out.strip().endswith(app_hash.hex())
    assert jcli.main(["--home", home, "replay"]) == 0
    assert capsys.readouterr().out == out
    monkeypatch.setattr(sys, "stdin", io.StringIO(""))
    cfg_file = config.config_file(home)
    text = open(cfg_file).read().replace('crypto_backend = "cuda"',
                                         'crypto_backend = "python"')
    open(cfg_file, "w").write(text)
    assert cli.main(["--home", home, "replay_console"]) == 0
    out = capsys.readouterr().out
    assert "records in" in out and "final round state" in out


def test_node_command_exits_nonzero_without_a_card(tmp_path):
    """`cli node` runs on the card by default: with no card it exits
    non-zero with the CudaBackend error."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    home = str(tmp_path / "h")
    cli.main(["--home", home, "init"])
    r = subprocess.run([sys.executable, "-m", "tendermint_tpu_torch.cli",
                        "--home", home, "node"], cwd=ROOT,
                       capture_output=True, text=True, timeout=120,
                       env={**os.environ, "PYTHONPATH": ROOT})
    assert r.returncode != 0
    assert "CudaBackend: no CUDA device" in r.stderr


class _Sink:
    """A socket's `sendall`, into memory."""

    def __init__(self):
        self.data = bytearray()

    def sendall(self, b: bytes) -> None:
        self.data += b


@pytest.mark.parametrize("n", [0, 1, 125, 126, 65535, 65536])
def test_websocket_frames_byte_equal(n):
    payload = "x" * n
    got = []
    for mod in (ws, jws):
        sock = _Sink()
        mod.send_text(sock, payload)
        mod.send_close(sock)
        buf = bytes(sock.data)
        got.append(buf)
        rfile = io.BytesIO(buf)
        for reader in (ws, jws):
            rfile.seek(0)
            assert reader.read_frame(rfile) == (0x1, payload.encode())
            assert reader.read_frame(rfile) == (0x8, b"")
    assert got[0] == got[1]
    key = "dGhlIHNhbXBsZSBub25jZQ=="
    assert ws.accept_key(key) == jws.accept_key(key) == \
        "s3pPLMBiTxaQ9kYGzzhZRbK+xOo="


def test_masked_client_frame_reads_the_same():
    """A client's masked frame (as `WSClient` sends it) decodes alike."""
    data = json.dumps({"method": "subscribe", "id": 1}).encode()
    mask = bytes([1, 2, 3, 4])
    frame = bytes([0x81, 0x80 | len(data)]) + mask + bytes(
        b ^ mask[i % 4] for i, b in enumerate(data))
    assert ws.read_frame(io.BytesIO(frame)) == jws.read_frame(
        io.BytesIO(frame)) == (0x1, data)


# -- snapshot list | create | verify | restore ---------------------------------

def _snap_home(tmp_path, name, gen_json, pkg_config):
    """A home with config.toml (persistent_kvstore, the golden verifier)
    and the genesis; returns (home, data dir)."""
    home = str(tmp_path / name)
    cfg = pkg_config.Config()
    cfg.base.home = home
    cfg.base.proxy_app = "persistent_kvstore"
    cfg.base.crypto_backend = "python"
    os.makedirs(cfg.base.db_dir(), exist_ok=True)
    with open(cfg.base.genesis_file(), "w") as f:
        f.write(gen_json)
    pkg_config.save_config_file(cfg, pkg_config.config_file(home))
    return home, cfg.base.db_dir()


def _snap_flow(main, home1, db1, home2, db2, capsys,
               before=lambda db: None):
    """`tests/test_statesync.py`'s `cli snapshot` flow on one package:
    (each command's exit code and output with the homes cut out).
    `before(data dir)` runs before each command."""
    out = []

    def run(*argv):
        before(db1 if argv[0] == home1 else db2)
        rc = main(["--home", argv[0], "snapshot", *argv[1:]])
        text = capsys.readouterr().out
        for h in (home1, home2):
            text = text.replace(h, "H")
        out.append((argv[1], rc, text))
        return rc

    snap_root = os.path.join(db1, "snapshots")
    run(home1, "create")
    run(home1, "list")
    run(home1, "list", "--json")
    run(home1, "verify", snap_root)
    run(home2, "restore", "--dir", snap_root)
    run(home2, "restore", "--dir", snap_root)           # refused
    sdir = [os.path.join(snap_root, d) for d in os.listdir(snap_root)][0]
    cpath = os.path.join(sdir, "chunk-000000.bin")
    data = bytearray(open(cpath, "rb").read())
    data[0] ^= 0xFF
    open(cpath, "wb").write(bytes(data))
    run(home1, "verify", snap_root)
    return out


def test_snapshot_commands_match_jax(tmp_path, capsys, monkeypatch):
    """create, list, verify, restore into a fresh home, a second restore
    refused and a corrupt chunk flagged, against the JAX commands on the
    same chain; the snapshot files, the restored state, block store and
    app file equal; a node built on the restored home reports the
    snapshot height and app hash."""
    from chainutil import (build_chain, kvstore_app_hashes, make_genesis,
                           make_validators)
    from tendermint_tpu.abci.apps.kvstore import \
        PersistentKVStoreApp as JPersistent
    from tendermint_tpu.proxy import ClientCreator as JClientCreator
    from tendermint_tpu.state import execution as jexecution
    from tendermint_tpu.state.state import get_state as jget_state
    from tendermint_tpu.utils.db import new_db as jnew_db
    from tendermint_tpu_torch.abci.apps.kvstore import PersistentKVStoreApp
    from tendermint_tpu_torch.blockchain.store import BlockStore
    from tendermint_tpu_torch.proxy import ClientCreator
    from tendermint_tpu_torch.state import execution
    from tendermint_tpu_torch.state.state import get_state
    from tendermint_tpu_torch.utils.db import new_db
    from torch_chains import port_chain

    privs, vs = make_validators(2, seed=4)
    jgen = make_genesis("cli-snap", privs)
    n = 6
    jchain = build_chain(privs, vs, "cli-snap", n,
                         app_hashes=kvstore_app_hashes(n))
    flows, trees, states = {}, {}, {}
    for name, pkg_main, pkg_config in (("jax", jcli.main, jconfig),
                                       ("port", cli.main, config)):
        home1, db1 = _snap_home(tmp_path / name, "home1", jgen.to_json(),
                                pkg_config)
        home2, db2 = _snap_home(tmp_path / name, "home2", jgen.to_json(),
                                pkg_config)
        app_file = os.path.join(db1, "kvstore_app.json")
        if name == "jax":
            app = JPersistent(app_file)
            conns = JClientCreator(app).new_app_conns()
            state = jget_state(jnew_db("sqlite", os.path.join(
                db1, "state.db")), jgen)
            for block, ps, _seen in jchain:
                jexecution.apply_block(state, None, conns.consensus, block,
                                       ps.header, jexecution.MockMempool(),
                                       check_last_commit=False)
            # the JAX commands find the app file through the environment
            flows[name] = _snap_flow(
                pkg_main, home1, db1, home2, db2, capsys,
                before=lambda db: monkeypatch.setenv(
                    "TM_KVSTORE_PATH", os.path.join(db, "kvstore_app.json")))
            monkeypatch.delenv("TM_KVSTORE_PATH")
        else:
            gen = GenesisDoc.from_json(jgen.to_json())
            app = PersistentKVStoreApp(app_file)
            conns = ClientCreator(app).new_app_conns()
            state = get_state(new_db("sqlite", os.path.join(db1,
                                                            "state.db")), gen)
            for block, ps, _seen in port_chain(jchain):
                execution.apply_block(state, conns.consensus, block,
                                      ps.header, execution.MockMempool())
            flows[name] = _snap_flow(pkg_main, home1, db1, home2, db2,
                                     capsys)
            bs = BlockStore(new_db("sqlite", os.path.join(db2,
                                                          "blockstore.db")))
            assert (bs.height, bs.base) == (n, n + 1)
            cfg = config.load_config_file(config.config_file(home2))
            cfg.base.home = home2
            cfg.rpc.laddr = cfg.p2p.laddr = ""
            node = Node(cfg)
            try:
                st = node.status()
            finally:
                node.plane.stop()
                node.mempool.close()
            assert st["latest_block_height"] == n
            assert st["latest_app_hash"] == state.app_hash.hex()
        trees[name] = {
            os.path.relpath(os.path.join(d, f), db1):
                open(os.path.join(d, f), "rb").read()
            for d, _dirs, files in os.walk(os.path.join(db1, "snapshots"))
            for f in files}
        states[name] = (open(os.path.join(db2, "kvstore_app.json")).read(),
                        state.encode())
    assert flows["port"] == flows["jax"]
    assert [(c, rc) for c, rc, _ in flows["port"]] == [
        ("create", 0), ("list", 0), ("list", 0), ("verify", 0),
        ("restore", 0), ("restore", 1), ("verify", 1)]
    assert trees["port"] == trees["jax"]
    assert json.loads(states["port"][0]) == json.loads(states["jax"][0])
    assert states["port"][1] == states["jax"][1]


@pytest.mark.parametrize("flags", [
    dict(crypto_supervised=True, crypto_breaker_threshold=2,
         crypto_call_timeout=5.0, crypto_spot_check=10),
    dict(crypto_supervised=False, crypto_breaker_threshold=0,
         crypto_call_timeout=0.0, crypto_spot_check=0)])
def test_node_ladder_flags_load_as_jax(tmp_path, flags):
    """`node --crypto-supervised` and its knobs fill `[crypto]` as the JAX
    command's do."""
    import argparse
    home = str(tmp_path / "h")
    args = argparse.Namespace(home=home, **flags)
    got = cli._load_config(args).crypto
    want = jcli._load_config(args).crypto
    assert vars(got) == vars(want)
    assert got.supervised is flags["crypto_supervised"]


# -- the observability commands ------------------------------------------------

def _dumps(tmp_path) -> dict:
    """A JAX and a port flight-recorder dump holding replay windows and
    consensus stages, and a ledger, on disk."""
    from tendermint_tpu.utils import tracing as jtracing
    from tendermint_tpu_torch.utils import tracing
    out = {}
    for tag, mod in (("jax", jtracing), ("port", tracing)):
        rec = mod.FlightRecorder(512)
        t = 1_700_000_000.0
        for w in range(4):
            for name, dur in (("fastsync.prepare", 0.02),
                              ("verify.collect", 0.01),
                              ("fastsync.apply", 0.03)):
                rec.record(name, t, dur, {"window": w})
                t += dur
            rec.record("consensus.stage.propose", t, 0.1,
                       {"height": w + 1, "node": "n0"})
            t += 0.005
        out[tag] = rec.dump(str(tmp_path / f"{tag}_trace.json"))
    led = tmp_path / "led.jsonl"
    with open(led, "w") as f:
        for i in range(3):
            f.write(json.dumps({"timestamp": f"t{i}", "configs": {
                "config3": {"sigs_per_sec": [900.0, 1000.0, 700.0][i]}}})
                + "\n")
    out["ledger"] = str(led)
    return out


def _run(main, argv, capsys):
    rc = main(argv)
    return rc, capsys.readouterr().out


@pytest.mark.parametrize("dump", ["jax", "port"])
@pytest.mark.parametrize("argv", [
    ["trace", "--format", "lines"],
    ["trace", "--format", "lines", "--last", "3", "--name", "fastsync"],
    ["trace", "--out", "{tmp}/out.json", "--last", "5"],
    ["doctor", "--json"],
    ["doctor"],
    ["timeline", "--json", "--out", ""],
    ["timeline", "--out", "{tmp}/tl.json"]],
    ids=lambda a: "-".join(x.strip("-") for x in a if "{" not in x))
def test_dump_commands_print_as_jax(tmp_path, capsys, dump, argv):
    """`trace --in`, `doctor --trace` and `timeline --trace` on the same
    dump print what the JAX commands print and write the same files."""
    files = _dumps(tmp_path)
    src = files[dump]
    cmd = argv[0]
    flag = {"trace": "--in", "doctor": "--trace", "timeline": "--trace"}[cmd]
    extra = ["--ledger", files["ledger"]] if cmd == "doctor" else []
    outs = []
    for main, tag in ((cli.main, "p"), (jcli.main, "j")):
        a = [x.replace("{tmp}", str(tmp_path / tag)) for x in argv]
        os.makedirs(tmp_path / tag, exist_ok=True)
        rc, out = _run(main, [a[0], flag, src, *a[1:], *extra], capsys)
        written = [open(x).read() for x in a if x.endswith(".json")
                   and os.path.exists(x)]
        outs.append((rc, out.replace(str(tmp_path / tag), "<tmp>"),
                     written))
    assert outs[0] == outs[1]
    assert outs[0][0] == 0


@pytest.mark.parametrize("entries", [0, 3])
def test_bench_history_prints_as_jax(tmp_path, capsys, entries):
    path = _dumps(tmp_path)["ledger"] if entries else str(tmp_path / "no")
    got = _run(cli.main, ["bench-history", "--ledger", path], capsys)
    want = _run(jcli.main, ["bench-history", "--ledger", path], capsys)
    assert got == want
    assert got[0] == (0 if entries else 1)


@pytest.fixture(scope="module")
def live():
    """A port solo validator with `rpc.unsafe` (the golden verifier)."""
    from tendermint_tpu_torch.types import (GenesisValidator, PrivKey)
    cfg = config.test_config()
    cfg.rpc.laddr = "tcp://127.0.0.1:0"
    cfg.p2p.laddr = ""
    cfg.rpc.unsafe = True
    pv = PrivValidator(PrivKey(b"\x21" * 32))
    n = Node(cfg, priv_validator=pv, genesis_doc=GenesisDoc(
        chain_id="obs", validators=[GenesisValidator(pv.pub_key.bytes_,
                                                     10)],
        genesis_time_ns=1))
    n.start()
    try:
        t0 = time.monotonic()
        while len(n.consensus.lifecycle) < 3 and time.monotonic() - t0 < 30:
            time.sleep(0.05)
        yield n
    finally:
        n.stop()


@pytest.mark.parametrize("cmd", ["trace", "doctor", "timeline"])
def test_commands_against_a_live_node(live, tmp_path, capsys, cmd):
    """The commands read a running port node over its unsafe routes;
    the timeline's every height partitions its wall."""
    addr = live.rpc_server.addr
    if cmd == "trace":
        out = str(tmp_path / "t.json")
        rc, text = _run(cli.main, ["trace", "--rpc", addr, "--out", out,
                                   "--name", "consensus."], capsys)
        doc = json.load(open(out))
        assert rc == 0 and "recorder total=" in text
        assert any(e["name"] == "consensus.height"
                   for e in doc["traceEvents"])
    elif cmd == "doctor":
        rc, text = _run(cli.main, ["doctor", "--rpc", addr, "--json",
                                   "--ledger", ""], capsys)
        assert rc == 0 and json.loads(text)["schema"] == "tpu-bft-doctor/1"
    else:
        rc, text = _run(cli.main, ["timeline", "--rpc", f"{addr},{addr}",
                                   "--json", "--out",
                                   str(tmp_path / "tl.json")], capsys)
        doc = json.loads(text)
        assert rc == 0 and doc["doctor"]["sums_to_wall"]
        assert len(doc["timeline"]["heights"]) >= 3
        for row in doc["timeline"]["heights"]:
            assert sum(row["stages"].values()) == pytest.approx(
                row["wall_s"], abs=1e-9)
        assert os.path.exists(tmp_path / "tl.json")


def test_commands_refused_without_unsafe(live):
    """A node without `rpc.unsafe` answers them "unknown method" (HTTP
    404), and the port's commands fail on it as the JAX ones do."""
    import urllib.error
    from tendermint_tpu_torch.rpc.routes import Routes
    saved = live.rpc_server.routes
    live.config.rpc.unsafe = False
    live.rpc_server.routes = Routes(live)
    try:
        for cmd in (["trace", "--format", "lines"], ["doctor"],
                    ["timeline", "--out", ""]):
            for main in (cli.main, jcli.main):
                if cmd[0] == "timeline":     # a dead node degrades: rc 1
                    assert main([*cmd, "--rpc", live.rpc_server.addr]) == 1
                    continue
                with pytest.raises(urllib.error.HTTPError) as e:
                    main([*cmd, "--rpc", live.rpc_server.addr])
                assert e.value.code == 404
    finally:
        live.config.rpc.unsafe = True
        live.rpc_server.routes = saved
