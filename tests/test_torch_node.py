"""The port's node and its JSON-RPC / WebSocket server held against the
JAX package's (`tests/test_node_rpc.py`): both nodes in process on the
same genesis and validator key (memdb, the golden verifier), every route
answering with the JAX route's keys, `_block_dict` and `_result_dict`
equal on the same bytes, the same app hash and query values after the
same blocks, the supervised ladder's `crypto_supervisor` status, the
observability routes (`GET /metrics`, `status.metrics`, the unsafe
`debug_*` routes) answering as the JAX ones do, and the port's refusals:
no card, gRPC and the JAX-only backends."""

import json
import os
import sys
import time
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
from tendermint_tpu_torch.utils import trace

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


OBSERVABILITY = ["metrics", "debug_trace_start", "debug_trace_stop",
                 "debug_flight_recorder", "debug_timeline", "debug_doctor",
                 "debug_bench_history"]


def _prom_types(addr: str) -> list:
    with urllib.request.urlopen(f"{addr}/metrics") as r:
        assert r.headers["Content-Type"].startswith("text/plain")
        return [ln for ln in r.read().decode().splitlines()
                if ln.startswith("# TYPE")]


def _unsafe_routes(node, mod):
    node.config.rpc.unsafe = True
    try:
        return mod.Routes(node)
    finally:
        node.config.rpc.unsafe = False


@pytest.mark.parametrize("method", OBSERVABILITY)
def test_observability_routes_match_jax(nodes, method, tmp_path,
                                        monkeypatch):
    """`GET /metrics` serves both packages' series; each `debug_*` route
    is refused without `rpc.unsafe`, as the JAX route is, and with it
    answers as the JAX route does on the same node state (the same
    keys; the same values where the answer is not the process's own
    recorder or clock; the same refusals of a bad name)."""
    n, jn = nodes
    if method == "metrics":
        got, want = (_prom_types(n.rpc_server.addr),
                     _prom_types(jn.rpc_server.addr))
        assert got == want and len(got) > 60
        with urllib.request.urlopen(f"{n.rpc_server.addr}/metrics") as r:
            text = r.read().decode()
        assert "tendermint_blocks_committed " in text
        assert 'crypto_backend="python"' in text
        return
    for node, cl in ((n, HTTPClient), (jn, JHTTPClient)):
        with pytest.raises(Exception, match="unknown method"):
            cl(node.rpc_server.addr).call(method)
        assert method not in jroutes.Routes(node).table
    r, jr = _unsafe_routes(n, routes), _unsafe_routes(jn, jroutes)
    assert method in r.table and method in jr.table
    if method == "debug_trace_start":
        for bad in ("..", "a/b", "x" * 65):
            with pytest.raises(ValueError) as e:
                r.debug_trace_start({"name": bad})
            with pytest.raises(ValueError) as je:
                jr.debug_trace_start({"name": bad})
            assert str(e.value) == str(je.value)
        monkeypatch.setattr("tempfile.tempdir", str(tmp_path))
        got = r.debug_trace_start({"name": "cap"})
        try:
            assert got == {"started": True,
                           "dir": str(tmp_path / routes.TRACE_BASE / "cap")}
            assert r.debug_trace_start({"name": "cap2"})["started"] is False
        finally:
            stopped = r.debug_trace_stop({})
        assert stopped == {"dir": got["dir"]}
        assert os.path.exists(os.path.join(got["dir"],
                                           trace.DEVICE_TRACE_FILE))
    elif method == "debug_trace_stop":
        assert r.debug_trace_stop({}) == jr.debug_trace_stop({}) == \
            {"dir": None}
    elif method == "debug_flight_recorder":
        for params in ({}, {"format": "chrome"},
                       {"name": "consensus.", "last": 3},
                       {"format": "chrome", "last": 2}):
            got, want = r.debug_flight_recorder(params), \
                jr.debug_flight_recorder(params)
            assert got.keys() == want.keys()
            assert got["capacity"] == want["capacity"] == 16384
            body = got.get("spans") or got["trace"]["traceEvents"]
            assert all("consensus." in s["name"] for s in body
                       if params.get("name") and s.get("ph") != "M")
        with pytest.raises(ValueError) as e:
            r.debug_flight_recorder({"format": "xml"})
        with pytest.raises(ValueError) as je:
            jr.debug_flight_recorder({"format": "xml"})
        assert str(e.value) == str(je.value)
    elif method == "debug_timeline":
        assert _wait(lambda: len(n.consensus.lifecycle) >= 2 and
                     len(jn.consensus.lifecycle) >= 2)
        got, want = r.debug_timeline({"last": 2}), \
            jr.debug_timeline({"last": 2})
        assert _keys(got) == _keys(want)
        assert got["node"] == want["node"] == n.config.base.moniker
        assert [rec.keys() for rec in got["records"]] == \
            [rec.keys() for rec in want["records"]]
        from tendermint_tpu import telemetry as jtelemetry
        assert [jtelemetry.normalize_record(rec) for rec in
                got["records"]] == got["records"]
    elif method == "debug_doctor":
        got, want = r.debug_doctor({}), jr.debug_doctor({})
        assert _keys(got, 3) == _keys(want, 3)
        assert got["report"]["schema"] == "tpu-bft-doctor/1"
    else:
        monkeypatch.chdir(tmp_path)
        led = [{"timestamp": f"t{i}", "configs": {
            "config3": {"sigs_per_sec": 100.0 * (i + 1)}}}
            for i in range(3)]
        with open(tmp_path / "led.jsonl", "w") as f:
            for e in led:
                f.write(json.dumps(e) + "\n")
        for params in ({"ledger": "led.jsonl"}, {"ledger": "none.jsonl"},
                       {}):
            assert r.debug_bench_history(params) == \
                jr.debug_bench_history(params)
        for bad in ("../etc/passwd", "a/b.jsonl", "."):
            with pytest.raises(ValueError) as e:
                r.debug_bench_history({"ledger": bad})
            with pytest.raises(ValueError) as je:
                jr.debug_bench_history({"ledger": bad})
            assert str(e.value) == str(je.value)


def test_node_applies_its_log_level():
    """The node applies `base.log_level` as the JAX node does."""
    from tendermint_tpu_torch.utils import log
    n = _node(base__log_level="consensus:error,*:info")
    try:
        assert not log.get_logger("consensus").enabled(log.INFO)
        assert log.get_logger("p2p").enabled(log.INFO)
    finally:
        n.plane.stop()
        n.mempool.close()
        log.set_level_spec("info")


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
    `status` without `crypto_supervisor`, which the JAX node adds only
    when supervised."""
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
                if k != "crypto_supervisor"}
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
    ({"crypto__supervised": True, "base__crypto_backend": "tpu"},
     "port's backends"),
    ({"base__crypto_backend": "tpu"}, "port's backends"),
    ({"base__crypto_backend": "supervised"}, "port's backends")])
def test_refused_settings(setting, match, monkeypatch):
    """gRPC without grpcio and the JAX package's tpu backend raise, bare
    or as the supervised ladder's primary, and so does "supervised" as a
    backend name (the ladder is `crypto.supervised`): the port has none of
    them, and no fallback runs.  (The JAX node warns and runs without its
    gRPC server when grpcio is missing.)"""
    monkeypatch.setitem(sys.modules, "grpc", None)     # grpcio absent
    error = ImportError if "rpc__grpc_laddr" in setting else ValueError
    with pytest.raises(error, match=match):
        _node(**setting)


@pytest.mark.parametrize("primary", ["python", "native"])
def test_supervised_status_keys_match_jax(primary):
    """With `crypto.supervised`, `status` carries `crypto_supervisor` with
    the JAX node's keys (its rungs' too), and the ladder runs from the
    configured rung down to the python floor."""
    old = jcb._current
    n = _node(crypto__supervised=True, base__crypto_backend=primary)
    jcfg = jfast_config()
    jcfg.rpc.laddr = jcfg.p2p.laddr = ""
    jcfg.crypto.supervised = True
    jcfg.base.crypto_backend = primary
    jpv = JPrivValidator(JPrivKey(SEED))
    try:
        jn = JNode(jcfg, priv_validator=jpv, genesis_doc=JGenesisDoc(
            chain_id=CHAIN, validators=[JGenesisValidator(
                jpv.pub_key.bytes_, 10)], genesis_time_ns=1))
        got, want = n.status(), jn.status()
    finally:
        n.plane.stop()
        n.mempool.close()
        jcb._current = old
    # `metrics` to its own keys: the labels under them (rungs, producers)
    # are what each package's process-wide registry has seen
    assert _keys(got.pop("metrics"), 1) == _keys(want.pop("metrics"), 1)
    assert _keys(got, 3) == _keys(want, 3)
    sup, jsup = got["crypto_supervisor"], want["crypto_supervisor"]
    assert [r.keys() for r in sup["rungs"]] == \
        [r.keys() for r in jsup["rungs"]]
    assert [r["name"] for r in sup["rungs"]] == \
        [r["name"] for r in jsup["rungs"]] == \
        ["native", "python"][["native", "python"].index(primary):]
    assert sup["active_rung"] == jsup["active_rung"] == primary
    assert sup["chaos"] is None


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
