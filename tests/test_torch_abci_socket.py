"""The port's socket ABCI (`abci/wire.py`, `server.py`, `client.py`, the
`tcp://` branch of `proxy.ClientCreator`) held against the JAX package's:
every message encodes to the same bytes, and a port client talks to a JAX
server and a JAX client to a port server, a full block included
(`tests/test_abci_socket.py:39-63`)."""

import socket

import pytest

from tendermint_tpu.abci import client as jclient
from tendermint_tpu.abci import server as jserver
from tendermint_tpu.abci import types as jtypes
from tendermint_tpu.abci import wire as jwire
from tendermint_tpu.abci.app import create_app as jcreate_app
from tendermint_tpu.crypto import backend as jcb
from tendermint_tpu.proxy import ClientCreator as JClientCreator
from tendermint_tpu.state import execution as jexecution
from tendermint_tpu.state.state import get_state as jget_state
from tendermint_tpu.types.block import Header as JHeader
from tendermint_tpu.types.codec import Reader as JReader
from tendermint_tpu.utils.db import MemDB as JMemDB
from tendermint_tpu_torch.abci import types
from tendermint_tpu_torch.abci import wire
from tendermint_tpu_torch.abci.app import create_app
from tendermint_tpu_torch.abci.client import (ABCIClientError,
                                              new_socket_app_conns)
from tendermint_tpu_torch.abci.server import ABCIServer
from tendermint_tpu_torch.proxy import ClientCreator
from tendermint_tpu_torch.scenarios import fixtures
from tendermint_tpu_torch.state import execution
from tendermint_tpu_torch.state.state import get_state
from tendermint_tpu_torch.utils.db import MemDB

from torch_chains import jax_block, jax_genesis

CHAIN = "sock-chain"


@pytest.fixture(scope="module")
def chain():
    privs, vs = fixtures.make_validators(4)
    gen = fixtures.make_genesis(CHAIN, privs)
    return gen, fixtures.build_chain(privs, vs, CHAIN, 1)


@pytest.fixture(autouse=True)
def _jax_python_backend():
    old = jcb._current
    jcb.set_backend("python")
    yield
    jcb._current = old


def _header(chain):
    return chain[1][0][0].header


def _encodings(chain):
    """(name, port bytes, JAX bytes) of every payload codec."""
    h = _header(chain)
    jh = JHeader.decode(JReader(h.encode()))
    vals = [(b"\x01" * 32, 10), (b"\x02" * 32, 0), (b"\x03" * 32, -5)]
    return [
        ("info", wire.encode_response_info(types.ResponseInfo(
            "d", "v", 7, b"\xaa" * 20)), jwire.encode_response_info(
            jtypes.ResponseInfo("d", "v", 7, b"\xaa" * 20))),
        ("query_response", wire.encode_response_query(types.ResponseQuery(
            1, 3, b"k", b"v", b"p", 9, "log")), jwire.encode_response_query(
            jtypes.ResponseQuery(1, 3, b"k", b"v", b"p", 9, "log"))),
        ("query_request", wire.encode_request_query(b"k", "/tx", 4, True),
         jwire.encode_request_query(b"k", "/tx", 4, True)),
        ("validators", wire.encode_validators(
            [types.Validator(p, w) for p, w in vals]),
         jwire.encode_validators([jtypes.Validator(p, w) for p, w in vals])),
        ("begin_block", wire.encode_request_begin_block(
            types.RequestBeginBlock(b"\x05" * 32, h)),
         jwire.encode_request_begin_block(
             jtypes.RequestBeginBlock(b"\x05" * 32, jh))),
        ("end_block", wire.encode_response_end_block(types.ResponseEndBlock(
            [types.Validator(p, w) for p, w in vals])),
         jwire.encode_response_end_block(jtypes.ResponseEndBlock(
             [jtypes.Validator(p, w) for p, w in vals]))),
        ("result", types.Result(3, b"data", "log").encode(),
         jtypes.Result(3, b"data", "log").encode()),
    ]


@pytest.mark.parametrize("i", range(7))
def test_payload_codecs_byte_equal_and_cross_decode(chain, i):
    name, mine, theirs = _encodings(chain)[i]
    assert mine == theirs, name
    decode = {"info": (wire.decode_response_info,
                       jwire.decode_response_info),
              "query_response": (wire.decode_response_query,
                                 jwire.decode_response_query),
              "query_request": (wire.decode_request_query,
                                jwire.decode_request_query)}.get(name)
    if decode is not None:
        a, b = decode[0](theirs), decode[1](mine)
        assert (a if isinstance(a, tuple) else vars(a)) == (
            b if isinstance(b, tuple) else vars(b))
    if name == "begin_block":
        got = wire.decode_request_begin_block(theirs)
        assert got.header.encode() == _header(chain).encode()


@pytest.mark.parametrize("msg_type", [
    wire.MSG_ECHO, wire.MSG_INFO, wire.MSG_SET_OPTION, wire.MSG_INIT_CHAIN,
    wire.MSG_QUERY, wire.MSG_BEGIN_BLOCK, wire.MSG_CHECK_TX,
    wire.MSG_DELIVER_TX, wire.MSG_END_BLOCK, wire.MSG_COMMIT,
    wire.MSG_EXCEPTION])
def test_frames_byte_equal(msg_type):
    names = [n for n in dir(wire) if n.startswith("MSG_")]
    assert {n: getattr(wire, n) for n in names} == {
        n: getattr(jwire, n) for n in names}
    payload = bytes(range(msg_type % 7 + 3))
    out = []
    for mod in (wire, jwire):
        a, b = socket.socketpair()
        with a, b:
            mod.write_frame(a, msg_type, payload)
            out.append(b.recv(1 << 16))
            a.sendall(out[-1])
            assert (wire if mod is jwire else jwire).read_frame(b) == (
                msg_type, payload)
    assert out[0] == out[1]


def _server(kind: str, app_name: str = "kvstore"):
    srv = (ABCIServer(create_app(app_name), "tcp://127.0.0.1:0")
           if kind == "port"
           else jserver.ABCIServer(jcreate_app(app_name), "tcp://127.0.0.1:0"))
    srv.start()
    return srv


def _conns(kind: str, addr: str):
    return (new_socket_app_conns(addr) if kind == "port"
            else jclient.new_socket_app_conns(addr))


def _session(conns) -> list:
    """One of each request, their answers as plain values."""
    out = [conns.query.echo(b"hello"), vars(conns.query.info()).copy()]
    out.append(conns.query.set_option("serial", "on"))
    out.append(vars(conns.mempool.check_tx(b"k=v")))
    out.append(vars(conns.consensus.deliver_tx(b"k=v")))
    out.append(vars(conns.consensus.deliver_tx(b"k2=v2")))
    out.append(vars(conns.consensus.end_block(1))["diffs"])
    out.append(vars(conns.consensus.commit()))
    out.append(vars(conns.query.query(b"k")))
    out.append(vars(conns.query.query(b"missing")))
    conns.consensus.init_chain([])
    out.append(vars(conns.query.info()))
    for c in (conns.mempool, conns.consensus, conns.query):
        c.close()
    return out


@pytest.mark.parametrize("client,server", [("port", "jax"), ("jax", "port"),
                                           ("port", "port")])
def test_client_and_server_across_packages(client, server):
    """The same answers whichever package runs either side."""
    srv = _server(server)
    ref = _server("jax")
    try:
        got = _session(_conns(client, srv.addr))
        want = _session(_conns("jax", ref.addr))
    finally:
        srv.stop()
        ref.stop()
    assert got == want
    assert got[0] == b"hello" and got[8]["value"] == b"v"


def test_port_block_over_a_jax_server(chain):
    """apply_block is transport-agnostic: the port's execution through a
    port client to a JAX app server gives the in-process app hash."""
    gen, blocks = chain
    block, ps, _ = blocks[0]
    srv = _server("jax")
    try:
        st = get_state(MemDB(), gen)
        conns = ClientCreator(srv.addr).new_app_conns()
        execution.apply_block(st, conns.consensus, block, ps.header,
                              execution.MockMempool())
        inproc = get_state(MemDB(), gen)
        execution.apply_block(inproc, ClientCreator(
            "kvstore").new_app_conns().consensus, block, ps.header,
            execution.MockMempool())
        assert st.last_block_height == 1
        assert st.app_hash and st.app_hash == inproc.app_hash
        assert conns.query.info().last_block_height == 1
    finally:
        srv.stop()


def test_jax_block_over_a_port_server(chain):
    gen, blocks = chain
    block, ps, _ = blocks[0]
    jblock = jax_block(block)
    srv = _server("port")
    try:
        st = jget_state(JMemDB(), jax_genesis(gen))
        conns = JClientCreator(srv.addr).new_app_conns()
        jexecution.apply_block(st, None, conns.consensus, jblock,
                               jblock.make_part_set().header,
                               jexecution.MockMempool())
        mine = get_state(MemDB(), gen)
        execution.apply_block(mine, ClientCreator(
            "kvstore").new_app_conns().consensus, block, ps.header,
            execution.MockMempool())
        assert st.app_hash == mine.app_hash and st.last_block_height == 1
        assert srv.app.height == 1
    finally:
        srv.stop()


def test_app_error_propagates_and_grpc_is_refused():
    srv = _server("port")
    try:
        conns = new_socket_app_conns(srv.addr)
        srv.app = None        # attribute access in dispatch raises
        with pytest.raises(ABCIClientError):
            conns.consensus.deliver_tx(b"x")
    finally:
        srv.stop()
    with pytest.raises(ValueError, match="grpcio"):
        ClientCreator("grpc://127.0.0.1:1").new_app_conns()


def test_counter_app_matches_jax():
    """The counter app, registered under its JAX names, in serial mode."""
    for name in ("counter", "counter_serial"):
        mine, theirs = create_app(name), jcreate_app(name)
        if name == "counter":
            assert mine.set_option("serial", "on") == theirs.set_option(
                "serial", "on") == "ok"
        for tx in (b"\x00", b"\x01", b"\x01", b"\x00" * 9, b"\x02"):
            assert vars(mine.check_tx(tx)) == vars(theirs.check_tx(tx))
            assert vars(mine.deliver_tx(tx)) == vars(theirs.deliver_tx(tx))
        assert vars(mine.commit()) == vars(theirs.commit())
        assert vars(mine.info()) == vars(theirs.info())
        for path in ("/tx", "/"):
            assert vars(mine.query(b"", path)) == vars(
                theirs.query(b"", path))
