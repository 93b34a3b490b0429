"""The port's gRPC surfaces held against the JAX package's
(`tests/test_grpc.py`, `tests/test_abci_grpc.py`):

- the broadcast API (`rpc/grpc_server.py`) on a port node: `Ping` and
  `BroadcastTx` answer a port client and a JAX client alike, a signed
  envelope commits and a forged one is refused by `check_tx`, and the
  raw response bytes equal a JAX node's for the same tx;
- ABCI over gRPC (`abci/grpc_app.py`, the `grpc://` branch of
  `proxy.ClientCreator`): each method's raw response bytes from a port
  server equal a JAX server's, a port client and a JAX client get the
  same answers from either package's server, app errors arrive as
  `ABCIClientError`, and a chain applied through `grpc://` gives the JAX
  fixture's app hashes;
- without grpcio the port imports, and its node, proxy and servers raise
  at start naming grpcio (the JAX node warns and runs without gRPC).
"""

import importlib
import sys
import time

import pytest

pytest.importorskip("grpc")

from tendermint_tpu.abci import grpc_app as jgrpc_app
from tendermint_tpu.abci.app import create_app as jcreate_app
from tendermint_tpu.abci.grpc_app import GRPCABCIServer as JGRPCABCIServer
from tendermint_tpu.abci.grpc_app import \
    new_grpc_app_conns as jnew_grpc_app_conns
from tendermint_tpu.config import test_config as jfast_config
from tendermint_tpu.crypto import backend as jcb
from tendermint_tpu.node.node import Node as JNode
from tendermint_tpu.rpc import grpc_server as jgrpc
from tendermint_tpu.scenarios import fixtures as jfixtures
from tendermint_tpu.types import (GenesisDoc as JGenesisDoc,
                                  GenesisValidator as JGenesisValidator,
                                  PrivKey as JPrivKey,
                                  PrivValidator as JPrivValidator)
from tendermint_tpu_torch.abci import grpc_app, wire
from tendermint_tpu_torch.abci.app import create_app
from tendermint_tpu_torch.abci.client import ABCIClientError
from tendermint_tpu_torch.abci.types import Validator
from tendermint_tpu_torch.config import test_config as fast_config
from tendermint_tpu_torch.mempool.mempool import sign_tx_ed25519
from tendermint_tpu_torch.node.node import Node
from tendermint_tpu_torch.proxy import ClientCreator
from tendermint_tpu_torch.rpc import grpc_server
from tendermint_tpu_torch.scenarios import fixtures
from tendermint_tpu_torch.state import execution
from tendermint_tpu_torch.state.state import get_state
from tendermint_tpu_torch.types import (GenesisDoc, GenesisValidator,
                                        PrivKey, PrivValidator)
from tendermint_tpu_torch.types.codec import lp_bytes, u64
from tendermint_tpu_torch.utils.db import MemDB

CHAIN = "grpc-chain"
KEY = b"\x22" * 32


def _wait_height(block_store, h: int, deadline_s: float = 20.0) -> bool:
    t0 = time.monotonic()
    while time.monotonic() - t0 < deadline_s:
        if block_store.height >= h:
            return True
        time.sleep(0.01)
    return False


@pytest.fixture(scope="module")
def nodes():
    """A port node and a JAX node on one genesis, each serving the
    broadcast API on a free port (JSON-RPC and p2p off)."""
    old = jcb._current
    jcb.set_backend("python")
    cfg = fast_config()
    cfg.rpc.laddr = cfg.p2p.laddr = ""
    cfg.rpc.grpc_laddr = "tcp://127.0.0.1:0"
    pv = PrivValidator(PrivKey(KEY))
    n = Node(cfg, priv_validator=pv, genesis_doc=GenesisDoc(
        chain_id=CHAIN, validators=[GenesisValidator(pv.pub_key.bytes_, 10)],
        genesis_time_ns=1))
    jcfg = jfast_config()
    jcfg.rpc.laddr = jcfg.p2p.laddr = ""
    jcfg.rpc.grpc_laddr = "tcp://127.0.0.1:0"
    jpv = JPrivValidator(JPrivKey(KEY))
    jn = JNode(jcfg, priv_validator=jpv, genesis_doc=JGenesisDoc(
        chain_id=CHAIN, validators=[JGenesisValidator(jpv.pub_key.bytes_,
                                                      10)],
        genesis_time_ns=1))
    n.start()
    jn.start()
    try:
        assert _wait_height(n.block_store, 1)
        assert _wait_height(jn.block_store, 1)
        yield n, jn
    finally:
        n.stop()
        jn.stop()
        jcb._current = old


def test_service_and_codec_equal_jax():
    assert grpc_server.SERVICE == jgrpc.SERVICE
    assert grpc_app.SERVICE == jgrpc_app.SERVICE
    assert grpc_app._METHODS == jgrpc_app._METHODS == {
        "Echo": wire.MSG_ECHO, "Info": wire.MSG_INFO,
        "SetOption": wire.MSG_SET_OPTION, "InitChain": wire.MSG_INIT_CHAIN,
        "Query": wire.MSG_QUERY, "BeginBlock": wire.MSG_BEGIN_BLOCK,
        "CheckTx": wire.MSG_CHECK_TX, "DeliverTx": wire.MSG_DELIVER_TX,
        "EndBlock": wire.MSG_END_BLOCK, "Commit": wire.MSG_COMMIT}
    res = {"check_tx": {"code": 3, "data": "abcd", "log": "bad sig"},
           "deliver_tx": {"code": 0, "data": "", "log": ""}}
    b = grpc_server._encode_result(res)
    assert b == jgrpc._encode_result(res)
    assert grpc_server.decode_result(b) == jgrpc.decode_result(b) == res
    assert grpc_server._encode_result({}) == jgrpc._encode_result({})


def test_ping_and_broadcast(nodes):
    """`tests/test_grpc.py`'s case on the port's node, then a signed
    envelope (committed) and a forged one (refused by check_tx)."""
    n, _ = nodes
    client = grpc_server.GRPCClient(n.grpc_server.laddr)
    try:
        assert client.ping()
        res = client.broadcast_tx(b"grpc=99")
        assert res["check_tx"]["code"] == 0
        assert res["deliver_tx"]["code"] == 0
        signed = sign_tx_ed25519(b"\x07" * 32, b"grpc-signed", priority=3)
        assert client.broadcast_tx(signed)["deliver_tx"]["code"] == 0
        forged = bytearray(sign_tx_ed25519(b"\x08" * 32, b"grpc-forged"))
        forged[40] ^= 1
        res = client.broadcast_tx(bytes(forged))
        assert res["check_tx"]["code"] != 0
        assert res["deliver_tx"] == {"code": 0, "data": "", "log": ""}
    finally:
        client.close()


def test_jax_client_and_raw_bytes_against_the_port_node(nodes):
    """The JAX client talks to the port's server, and the port's server
    answers a tx with the JAX node's bytes."""
    import grpc
    n, jn = nodes
    jclient = jgrpc.GRPCClient(n.grpc_server.laddr)
    try:
        assert jclient.ping()
        res = jclient.broadcast_tx(b"jax-client=1")
        assert res["check_tx"]["code"] == 0 == res["deliver_tx"]["code"]
    finally:
        jclient.close()
    got = []
    for laddr in (n.grpc_server.laddr, jn.grpc_server.laddr):
        with grpc.insecure_channel(laddr) as chan:
            call = chan.unary_unary(
                f"/{jgrpc.SERVICE}/BroadcastTx",
                request_serializer=lambda b: b,
                response_deserializer=lambda b: b)
            got.append(call(lp_bytes(b"same=bytes"), timeout=30))
    assert got[0] == got[1]


# -- ABCI over gRPC ----------------------------------------------------------

def _abci_servers(app_name="kvstore"):
    srv = grpc_app.GRPCABCIServer(create_app(app_name), "tcp://127.0.0.1:0")
    jsrv = JGRPCABCIServer(jcreate_app(app_name), "tcp://127.0.0.1:0")
    srv.start()
    jsrv.start()
    return srv, jsrv


RAW_CALLS = [
    ("Echo", b"hello"), ("Info", b""), ("SetOption",
                                         lp_bytes(b"serial") + lp_bytes(b"on")),
    ("CheckTx", lp_bytes(b"k=v")), ("DeliverTx", lp_bytes(b"k=v")),
    ("DeliverTx", lp_bytes(b"k2=v2")), ("EndBlock", u64(1)), ("Commit", b""),
    ("Query", wire.encode_request_query(b"k", "/", 0, False)),
    ("Query", wire.encode_request_query(b"missing", "/", 0, False)),
    ("InitChain", wire.encode_validators([Validator(b"\x01" * 32, 10)])),
    ("Info", b"")]


def test_abci_raw_bytes_equal_jax_server():
    import grpc
    srv, jsrv = _abci_servers()
    try:
        out = []
        for addr in (srv.addr, jsrv.addr):
            with grpc.insecure_channel(addr.replace("grpc://", "")) as ch:
                out.append([ch.unary_unary(
                    f"/{grpc_app.SERVICE}/{name}",
                    request_serializer=lambda b: b,
                    response_deserializer=lambda b: b)(payload, timeout=10)
                    for name, payload in RAW_CALLS])
    finally:
        srv.stop()
        jsrv.stop()
    assert out[0] == out[1]
    assert out[0][0] == b"hello"


def _session(conns) -> list:
    out = [conns.query.echo(b"hello"), vars(conns.query.info()).copy()]
    out.append(conns.mempool.check_tx(b"k=v").code)
    out.append(vars(conns.consensus.deliver_tx(b"k=v")))
    out.append(vars(conns.consensus.commit()))
    out.append(vars(conns.query.query(b"k")))
    return out


@pytest.mark.parametrize("client,server", [("port", "jax"), ("jax", "port"),
                                           ("port", "port")])
def test_abci_client_and_server_across_packages(client, server):
    srv, jsrv = _abci_servers()
    ref = JGRPCABCIServer(jcreate_app("kvstore"), "tcp://127.0.0.1:0")
    ref.start()
    try:
        addr = srv.addr if server == "port" else jsrv.addr
        conns = (grpc_app.new_grpc_app_conns(addr) if client == "port"
                 else jnew_grpc_app_conns(addr))
        got = _session(conns)
        want = _session(jnew_grpc_app_conns(ref.addr))
    finally:
        for s in (srv, jsrv, ref):
            s.stop()
    assert got == want
    assert got[0] == b"hello" and got[5]["value"] == b"v"


def test_abci_app_error_propagates():
    srv = grpc_app.GRPCABCIServer(create_app("kvstore"), "tcp://127.0.0.1:0")
    srv.start()
    try:
        conns = grpc_app.new_grpc_app_conns(srv.addr)
        srv.app = None  # attribute access in dispatch raises -> INTERNAL
        with pytest.raises(ABCIClientError):
            conns.consensus.deliver_tx(b"x")
    finally:
        srv.stop()


def test_counter_app_over_grpc():
    """The counter app in serial mode over gRPC (`tests/test_abci_grpc.py`'s
    conformance case)."""
    srv = grpc_app.GRPCABCIServer(create_app("counter"), "tcp://127.0.0.1:0")
    srv.start()
    try:
        conns = ClientCreator(srv.addr).new_app_conns()
        assert conns.query.set_option("serial", "on") in ("", "ok")
        assert conns.mempool.check_tx((0).to_bytes(8, "big")).is_ok
        for i in range(3):
            assert conns.consensus.deliver_tx(i.to_bytes(8, "big")).is_ok
        assert not conns.consensus.deliver_tx((9).to_bytes(8, "big")).is_ok
        assert not conns.mempool.check_tx((1).to_bytes(8, "big")).is_ok
        assert conns.consensus.commit().is_ok
        assert conns.query.query(b"", path="/tx").value == b"3"
    finally:
        srv.stop()


@pytest.mark.parametrize("server", ["port", "jax"])
def test_chain_through_grpc_gives_the_jax_app_hashes(server):
    """Blocks applied by the port's execution through `grpc://` (a port
    or a JAX app server) commit the JAX fixture's app hashes."""
    n_blocks, tpb = 4, 3
    privs, vs = fixtures.make_validators(4)
    gen = fixtures.make_genesis(CHAIN, privs)
    chain = fixtures.build_chain(
        privs, vs, CHAIN, n_blocks, txs_per_block=tpb,
        app_hashes=fixtures.kvstore_app_hashes(n_blocks, txs_per_block=tpb))
    want = jfixtures.kvstore_app_hashes(n_blocks + 1, txs_per_block=tpb)[1:]
    srv = (grpc_app.GRPCABCIServer(create_app("kvstore"), "tcp://127.0.0.1:0")
           if server == "port" else
           JGRPCABCIServer(jcreate_app("kvstore"), "tcp://127.0.0.1:0"))
    srv.start()
    try:
        st = get_state(MemDB(), gen)
        conns = ClientCreator(srv.addr).new_app_conns()
        got = []
        for block, ps, _ in chain:
            execution.apply_block(st, conns.consensus, block, ps.header,
                                  execution.MockMempool())
            got.append(st.app_hash)
        assert conns.query.info().last_block_height == n_blocks
    finally:
        srv.stop()
    assert got == want


# -- without grpcio ------------------------------------------------------------

def test_without_grpcio_the_port_imports_and_refuses_at_start(monkeypatch):
    monkeypatch.setitem(sys.modules, "grpc", None)
    for mod in (grpc_server, grpc_app):
        importlib.reload(mod)
    try:
        cfg = fast_config()
        cfg.rpc.laddr = cfg.p2p.laddr = ""
        cfg.rpc.grpc_laddr = "tcp://127.0.0.1:0"
        pv = PrivValidator(PrivKey(KEY))
        gen = GenesisDoc(chain_id=CHAIN, validators=[
            GenesisValidator(pv.pub_key.bytes_, 10)], genesis_time_ns=1)
        with pytest.raises(ImportError, match="grpcio"):
            Node(cfg, priv_validator=pv, genesis_doc=gen)
        with pytest.raises(ImportError, match="grpcio"):
            ClientCreator("grpc://127.0.0.1:1").new_app_conns()
        with pytest.raises(ImportError, match="grpcio"):
            grpc_app.GRPCABCIServer(create_app("kvstore"))
        with pytest.raises(ImportError, match="grpcio"):
            grpc_server.GRPCClient("127.0.0.1:1")
    finally:
        monkeypatch.undo()
        for mod in (grpc_server, grpc_app):
            importlib.reload(mod)
