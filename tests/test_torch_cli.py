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
