"""The port's node and its JSON-RPC / WebSocket server held against the
JAX package's (`tests/test_node_rpc.py`): both nodes in process on the
same genesis and validator key (memdb, the golden verifier), every route
answering with the JAX route's keys, `_block_dict` and `_result_dict`
equal on the same bytes, the same app hash and query values after the
same blocks, and the port's refusals: no card, gRPC, the supervised
ladder and the JAX-only backends."""

import json
import time
import urllib.error
import urllib.request

import pytest

from tendermint_tpu.abci.app import create_app as jcreate_app
from tendermint_tpu.abci.types import Result as JResult
from tendermint_tpu.config import test_config as jfast_config
from tendermint_tpu.crypto import backend as jcb
from tendermint_tpu.node.node import Node as JNode
from tendermint_tpu.rpc import routes as jroutes
from tendermint_tpu.rpc.client import HTTPClient as JHTTPClient
from tendermint_tpu.state.execution import \
    exec_commit_block as jexec_commit_block
from tendermint_tpu.types import (GenesisDoc as JGenesisDoc,
                                  GenesisValidator as JGenesisValidator,
                                  PrivKey as JPrivKey,
                                  PrivValidator as JPrivValidator)
from tendermint_tpu.proxy import ClientCreator as JClientCreator
from tendermint_tpu_torch.abci.types import Result
from tendermint_tpu_torch.config import test_config as fast_config
from tendermint_tpu_torch.node.node import Node
from tendermint_tpu_torch.rpc import routes
from tendermint_tpu_torch.rpc.client import (HTTPClient, LocalClient,
                                             RPCError, WSClient)
from tendermint_tpu_torch.rpc.routes import Routes
from tendermint_tpu_torch.types import (GenesisDoc, GenesisValidator,
                                        PrivKey, PrivValidator,
                                        TYPE_PREVOTE, Vote, ZERO_BLOCK_ID)
from tendermint_tpu_torch.types import events as ev

from torch_chains import jax_block

CHAIN = "rpc-chain"
SEED = b"\x11" * 32
DEADLINE_S = 20.0


def _wait(cond, deadline_s: float = DEADLINE_S) -> bool:
    t0 = time.monotonic()
    while time.monotonic() - t0 < deadline_s:
        if cond():
            return True
        time.sleep(0.01)
    return cond()


def _genesis():
    pv = PrivValidator(PrivKey(SEED))
    return pv, GenesisDoc(chain_id=CHAIN, validators=[
        GenesisValidator(pv.pub_key.bytes_, 10)], genesis_time_ns=1)


def _node(**cfg_kw):
    cfg = fast_config()
    cfg.rpc.laddr = "tcp://127.0.0.1:0"
    cfg.p2p.laddr = ""
    for k, v in cfg_kw.items():
        section, key = k.split("__")
        setattr(getattr(cfg, section), key, v)
    pv, gen = _genesis()
    return Node(cfg, priv_validator=pv, genesis_doc=gen)


@pytest.fixture(scope="module")
def nodes():
    """A port node and a JAX node on the same genesis and key."""
    old = jcb._current
    n = _node()
    jcfg = jfast_config()
    jcfg.rpc.laddr = "tcp://127.0.0.1:0"
    jcfg.p2p.laddr = ""
    jpv = JPrivValidator(JPrivKey(SEED))
    jn = JNode(jcfg, priv_validator=jpv, genesis_doc=JGenesisDoc(
        chain_id=CHAIN, validators=[JGenesisValidator(jpv.pub_key.bytes_,
                                                      10)],
        genesis_time_ns=1))
    n.start()
    jn.start()
    try:
        assert _wait(lambda: n.block_store.height >= 1 and
                     jn.block_store.height >= 1)
        yield n, jn
    finally:
        n.stop()
        jn.stop()
        jcb._current = old


@pytest.fixture
def node(nodes):
    return nodes[0]


@pytest.fixture
def client(node):
    return HTTPClient(node.rpc_server.addr)


# -- the counterparts of tests/test_node_rpc.py --------------------------------

def test_status(node, client):
    st = client.status()
    assert st["node_info"]["network"] == CHAIN
    assert st["latest_block_height"] >= 1
    assert st["validator_count"] == 1


def test_broadcast_tx_commit_lands(node, client):
    res = client.broadcast_tx_commit(tx="0x" + b"rpc=42".hex())
    assert res["check_tx"]["code"] == 0
    assert res["deliver_tx"]["code"] == 0
    assert res["height"] >= 1
    q = client.abci_query(data=b"rpc".hex())
    assert bytes.fromhex(q["value"]) == b"42"
    tx_res = client.tx(hash=res["hash"])
    assert tx_res["height"] == res["height"]
    assert bytes.fromhex(tx_res["tx"]) == b"rpc=42"


def test_block_and_blockchain_routes(node, client):
    client.broadcast_tx_commit(tx="0x" + b"r2=1".hex())
    h = node.block_store.height
    assert client.block(height=h)["block"]["header"]["height"] == h
    bc = client.blockchain()
    assert bc["last_height"] >= h
    assert bc["block_metas"][0]["height"] == bc["last_height"]
    assert client.commit(height=h)["precommits"] == 1
    assert len(client.validators()["validators"]) == 1
    assert client.genesis()["genesis"]["chain_id"] == CHAIN
    assert client.dump_consensus_state()["round_state"]["height"] >= h


def test_uri_get_endpoints(node):
    addr = node.rpc_server.addr
    with urllib.request.urlopen(f"{addr}/status") as r:
        assert json.loads(r.read())["result"]["latest_block_height"] >= 1
    with urllib.request.urlopen(f"{addr}/num_unconfirmed_txs") as r:
        assert "n_txs" in json.loads(r.read())["result"]
    with urllib.request.urlopen(addr) as r:
        assert "status" in json.loads(r.read())["routes"]


def test_unknown_method_and_errors(node, client):
    with pytest.raises(RPCError, match="unknown method"):
        client.call("not_a_method")
    with pytest.raises(RPCError, match="no block"):
        client.block(height=10_000_000)


def test_websocket_new_block_subscription(node):
    ws = WSClient(node.rpc_server.addr)
    try:
        ws.subscribe(ev.NEW_BLOCK)
        msg = ws.recv()
        assert msg["method"] == "event"
        assert msg["params"]["event"] == ev.NEW_BLOCK
        assert msg["params"]["data"]["height"] >= 1
    finally:
        ws.close()


def test_local_client(node):
    assert LocalClient(node).status()["latest_block_height"] >= 1


def test_status_reports_live_state(node, client):
    before = client.status()
    client.broadcast_tx_commit(tx="0x" + b"live=state".hex())
    after = client.status()
    assert after["latest_block_height"] > before["latest_block_height"]
    assert after["latest_app_hash"] != before["latest_app_hash"]
    assert _wait(lambda: client.status()["latest_app_hash"] ==
                 node.consensus.state.app_hash.hex())


def test_unsafe_routes_gated(node, client):
    with pytest.raises(RPCError):
        client.call("unsafe_flush_mempool")
    node.config.rpc.unsafe = True
    try:
        r = Routes(node)
        assert {"unsafe_flush_mempool", "unsafe_dial_seeds",
                "debug_stacks"} <= set(r.table)
        node.mempool.check_tx(b"zz=1")
        assert r.unsafe_flush_mempool({})["flushed"]
        assert node.mempool.size() == 0
        assert any("consensus" in t for t in r.debug_stacks({})["threads"])
        with pytest.raises(ValueError, match="no p2p switch"):
            r.unsafe_dial_seeds({"seeds": "127.0.0.1:1"})
    finally:
        node.config.rpc.unsafe = False


@pytest.mark.parametrize("method", [
    "metrics", "debug_trace_start", "debug_trace_stop",
    "debug_flight_recorder", "debug_timeline", "debug_doctor",
    "debug_bench_history"])
def test_observability_routes_answer_unknown_method(node, method):
    """The JAX package's metrics and tracing routes wait for the port's
    observability modules: GET and POST both say unknown method, also
    with rpc.unsafe set."""
    node.config.rpc.unsafe = True
    try:
        srv_routes = node.rpc_server.routes
        node.rpc_server.routes = Routes(node)
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(f"{node.rpc_server.addr}/{method}")
        assert e.value.code == 404
        with pytest.raises(RPCError, match="unknown method"):
            HTTPClient(node.rpc_server.addr).call(method)
    finally:
        node.rpc_server.routes = srv_routes
        node.config.rpc.unsafe = False


def test_validators_route_accum_snapshot(node, client):
    for _ in range(3):
        (v,) = client.validators()["validators"]
        assert v["accum"] == 0 and v["voting_power"] == 10


# -- against the JAX node ----------------------------------------------------

def _calls(node, tx: bytes):
    h = 1
    return {
        "status": {}, "abci_info": {}, "abci_query": {"data": "00"},
        "block": {"height": h}, "blockchain": {}, "commit": {"height": h},
        "validators": {}, "genesis": {}, "dump_consensus_state": {},
        "evidence": {}, "net_info": {}, "unconfirmed_txs": {},
        "num_unconfirmed_txs": {},
        "broadcast_tx_async": {"tx": "0x" + tx.hex()},
        "broadcast_tx_sync": {"tx": "0x" + (tx + b"s").hex()},
        "broadcast_tx_commit": {"tx": "0x" + (tx + b"c").hex()},
    }


def _keys(d, depth: int = 2):
    """The key tree of a route's answer, `depth` levels deep."""
    if not isinstance(d, dict) or depth == 0:
        return None
    return {k: _keys(v, depth - 1) for k, v in d.items()}


@pytest.mark.parametrize("method", list(_calls(None, b"")) + ["tx"])
def test_route_keys_match_jax(nodes, method):
    """Each route answers with the JAX route's keys (two levels deep);
    `status` without `metrics` (and `crypto_supervisor`, which the JAX
    node adds only when supervised)."""
    n, jn = nodes
    tx = b"keys-%s=1" % method.encode()
    if method == "tx":
        r = HTTPClient(n.rpc_server.addr).broadcast_tx_commit(
            tx="0x" + tx.hex())
        jr = JHTTPClient(jn.rpc_server.addr).broadcast_tx_commit(
            tx="0x" + tx.hex())
        params, jparams = {"hash": r["hash"]}, {"hash": jr["hash"]}
    else:
        params = jparams = _calls(n, tx)[method]
    got = HTTPClient(n.rpc_server.addr).call(method, **params)
    want = JHTTPClient(jn.rpc_server.addr).call(method, **jparams)
    if method == "status":
        want = {k: v for k, v in want.items()
                if k not in ("metrics", "crypto_supervisor")}
    if method == "net_info":
        assert got == want == {"listening": False, "peers": []}
    assert _keys(got) == _keys(want)


def test_block_and_result_dicts_equal_on_the_same_bytes(node):
    for h in range(1, node.block_store.height + 1)[:5]:
        b = node.block_store.load_block(h)
        assert routes._block_dict(b) == jroutes._block_dict(jax_block(b))
    for code, data, log in ((0, b"", ""), (3, b"\x01\x02", "bad sig")):
        assert routes._result_dict(Result(code, data, log)) == \
            jroutes._result_dict(JResult(code, data, log))


def test_app_hash_and_queries_equal_after_the_same_blocks(node, client):
    """The port node's blocks replayed into a JAX kvstore give the port
    node's app hash, and the same values to the same queries."""
    client.broadcast_tx_commit(tx="0x" + b"same=blocks".hex())
    st = node.consensus.state
    h = st.last_block_height
    jconns = JClientCreator(jcreate_app("kvstore")).new_app_conns()
    app_hash = b""
    for i in range(1, h + 1):
        app_hash = jexec_commit_block(jconns.consensus,
                                      jax_block(node.block_store.load_block(i)))
    assert app_hash == st.app_hash
    for key in (b"same", b"rpc", b"r2", b"missing"):
        got = client.abci_query(data=key.hex())
        want = jconns.query.query(key)
        assert (bytes.fromhex(got["value"]), got["code"]) == (want.value,
                                                            want.code)


def test_cuda_backend_refused_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _node(base__crypto_backend="cuda")


@pytest.mark.parametrize("setting,match", [
    ({"rpc__grpc_laddr": "tcp://127.0.0.1:0"}, "grpcio"),
    ({"crypto__supervised": True}, "supervised"),
    ({"base__crypto_backend": "tpu"}, "A.2"),
    ({"base__crypto_backend": "native"}, "A.2")])
def test_refused_settings(setting, match):
    """gRPC, the supervised ladder and the JAX package's tpu and native
    backends raise: the port has none of them, and no fallback runs."""
    with pytest.raises(ValueError, match=match):
        _node(**setting)


def test_evidence_from_the_consensus_state_lands_in_the_pool(nodes):
    """Two conflicting prevotes signed with the validator's key, fed to the
    consensus state of a node that waits for txs, land in the pool as one
    piece of evidence, served over RPC as the JAX route serves it
    (`tests/test_evidence.py:70`)."""
    n = _node(consensus__create_empty_blocks=False)
    n.start()
    try:
        pv, _ = _genesis()
        assert _wait(lambda: n.consensus.height >= 2)
        h = n.consensus.height

        def vote(block_id):
            v = Vote(validator_address=pv.address, validator_index=0,
                     height=h, round=0, type=TYPE_PREVOTE,
                     block_id=block_id)
            return Vote(**{**v.__dict__, "signature": pv.priv_key.sign(
                v.sign_bytes(CHAIN))})
        bid = n.block_store.load_block_meta(1).block_id
        n.consensus.add_vote(vote(bid), peer_id="test")
        n.consensus.add_vote(vote(ZERO_BLOCK_ID), peer_id="test")
        assert _wait(lambda: n.evidence_pool.size() == 1)
        got = HTTPClient(n.rpc_server.addr).evidence()
    finally:
        n.stop()
    assert got["count"] == 1
    assert got["evidence"][0]["vote_a"]["height"] == h
    assert got["evidence"][0]["vote_a"]["validator"] == pv.address.hex()
    # the JAX node stores the same proof and serves the same dict
    jn = nodes[1]
    from tendermint_tpu.types.codec import Reader as JReader
    from tendermint_tpu.types.vote import (DuplicateVoteEvidence as JEv,
                                           Vote as JVote)
    (e,) = n.evidence_pool.pending()
    jn.evsw.fire("EvidenceDoubleSign", JEv(
        JVote.decode(JReader(e.vote_a.encode())),
        JVote.decode(JReader(e.vote_b.encode()))))
    assert _wait(lambda: jn.evidence_pool.size() == 1)
    assert jroutes.Routes(jn).evidence({}) == got
