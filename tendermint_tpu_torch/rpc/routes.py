"""RPC route handlers: node introspection and the tx write path.

Reference: `rpc/core/routes.go:8-46` (route table), `rpc/core/mempool.go`
(broadcast_tx_*; `BroadcastTxCommit` = CheckTx + subscribe to the per-tx
DeliverTx event with a timeout, `:48-104`), `rpc/core/pipe.go` (node
wiring).  Handlers return JSON-serializable dicts.

Copy of `tendermint_tpu/rpc/routes.py`.  The tracing and telemetry
routes (`debug_trace_start|stop`, `debug_flight_recorder`,
`debug_timeline`, `debug_doctor`, `debug_bench_history`) are served only
with `rpc.unsafe`, as in the JAX package.  `debug_trace_start` takes a
`torch.profiler` capture of the card (`utils/trace.py`) into a flat
directory under `TRACE_BASE` in the temporary directory, where the JAX
route writes under `/tmp`.
"""

from __future__ import annotations

import json
import os
import re
import tempfile
import threading
import time

from tendermint_tpu_torch.p2p.types import NetAddress
from tendermint_tpu_torch.types import merkle
from tendermint_tpu_torch.types.events import event_tx
from tendermint_tpu_torch.types.tx import Tx
from tendermint_tpu_torch.utils import attribution, ledger, trace, tracing
from tendermint_tpu_torch.utils.metrics import REGISTRY

BROADCAST_TX_COMMIT_TIMEOUT = 60.0   # reference: 60s-120s
TRACE_BASE = "tendermint_tpu_torch_trace"   # under the temporary directory
_FLAT_NAME = r"[A-Za-z0-9._-]{1,64}"


def _flat_path(base: str, name: str, what: str, escapes: str) -> str:
    """`base/name` for an RPC-given `name` that must be a flat file or
    directory name (no path escape, no arbitrary-directory writes);
    `what` and `escapes` word the JAX route's two refusals."""
    if not re.fullmatch(_FLAT_NAME, name) or set(name) == {"."}:
        raise ValueError(f"{what} must match {_FLAT_NAME}")
    base = os.path.realpath(base)
    path = os.path.realpath(os.path.join(base, name))
    if os.path.dirname(path) != base:
        raise ValueError(escapes)
    return path


def _hexb(b: bytes) -> str:
    return b.hex()


def _parse_tx(params: dict) -> bytes:
    tx = params.get("tx")
    if tx is None:
        raise ValueError("missing param: tx")
    if isinstance(tx, str):
        if tx.startswith("0x"):
            tx = tx[2:]
        return bytes.fromhex(tx)
    raise ValueError("tx must be a hex string")


def _result_dict(res) -> dict:
    return {"code": res.code, "data": _hexb(res.data), "log": res.log}


def _block_dict(block) -> dict:
    h = block.header
    return {
        "header": {
            "chain_id": h.chain_id, "height": h.height,
            "time_ns": h.time_ns, "num_txs": h.num_txs,
            "last_block_id": {"hash": _hexb(h.last_block_id.hash)},
            "last_commit_hash": _hexb(h.last_commit_hash),
            "data_hash": _hexb(h.data_hash),
            "validators_hash": _hexb(h.validators_hash),
            "app_hash": _hexb(h.app_hash),
        },
        "block_hash": _hexb(block.hash()),
        "txs": [_hexb(tx) for tx in block.txs],
        "last_commit": {
            "block_id": {"hash": _hexb(block.last_commit.block_id.hash)},
            "precommits": sum(v is not None
                              for v in block.last_commit.precommits),
        },
    }


class Routes:
    """One instance per node; `table` maps method name -> handler."""

    def __init__(self, node):
        self.node = node
        self.table = {
            "status": self.status,
            "abci_info": self.abci_info,
            "abci_query": self.abci_query,
            "block": self.block,
            "blockchain": self.blockchain,
            "commit": self.commit,
            "validators": self.validators,
            "genesis": self.genesis,
            "dump_consensus_state": self.dump_consensus_state,
            "broadcast_tx_async": self.broadcast_tx_async,
            "broadcast_tx_sync": self.broadcast_tx_sync,
            "broadcast_tx_commit": self.broadcast_tx_commit,
            "unconfirmed_txs": self.unconfirmed_txs,
            "num_unconfirmed_txs": self.num_unconfirmed_txs,
            "tx": self.tx,
            "net_info": self.net_info,
            "evidence": self.evidence,
        }
        if getattr(node.config.rpc, "unsafe", False):
            # operator-only routes, served only with rpc.unsafe = true
            # (reference rpc/core/routes.go:30-46 AddUnsafeRoutes — the
            # profiler/debug API is unsafe-gated there too)
            self.table.update({
                "unsafe_flush_mempool": self.unsafe_flush_mempool,
                "unsafe_dial_seeds": self.unsafe_dial_seeds,
                "debug_stacks": self.debug_stacks,
                "debug_trace_start": self.debug_trace_start,
                "debug_trace_stop": self.debug_trace_stop,
                "debug_flight_recorder": self.debug_flight_recorder,
                "debug_doctor": self.debug_doctor,
                "debug_timeline": self.debug_timeline,
                "debug_bench_history": self.debug_bench_history,
            })

    # -- info routes ----------------------------------------------------
    def status(self, params: dict) -> dict:
        return self.node.status()

    def abci_info(self, params: dict) -> dict:
        info = self.node.proxy_app.query.info()
        return {"data": info.data, "version": info.version,
                "last_block_height": info.last_block_height,
                "last_block_app_hash": _hexb(info.last_block_app_hash)}

    def abci_query(self, params: dict) -> dict:
        data = params.get("data", "")
        if data.startswith("0x"):       # same prefix tolerance as the tx
            data = data[2:]             # routes (reference accepts both)
        data = bytes.fromhex(data)
        path = params.get("path", "/")
        height = int(params.get("height", 0))
        prove = bool(params.get("prove", False))
        r = self.node.proxy_app.query.query(data, path, height, prove)
        return {"code": r.code, "key": _hexb(r.key), "value": _hexb(r.value),
                "height": r.height, "log": r.log}

    def block(self, params: dict) -> dict:
        height = int(params["height"])
        block = self.node.block_store.load_block(height)
        if block is None:
            raise ValueError(f"no block at height {height}")
        return {"block": _block_dict(block)}

    def blockchain(self, params: dict) -> dict:
        """Reference rpc/core/blocks.go BlockchainInfo: metas for a range."""
        store = self.node.block_store
        max_h = int(params.get("maxHeight", store.height) or store.height)
        max_h = min(max_h, store.height)
        min_h = int(params.get("minHeight", max(1, max_h - 19)))
        metas = []
        for h in range(max_h, min_h - 1, -1):
            m = store.load_block_meta(h)
            if m is None:
                break
            metas.append({"height": m.height, "num_txs": m.num_txs,
                          "block_hash": _hexb(m.block_id.hash)})
        return {"last_height": store.height, "block_metas": metas}

    def commit(self, params: dict) -> dict:
        height = int(params["height"])
        store = self.node.block_store
        commit = (store.load_seen_commit(height)
                  if height == store.height
                  else store.load_block_commit(height))
        if commit is None:
            raise ValueError(f"no commit for height {height}")
        return {
            "canonical": height != store.height,
            "block_id": {"hash": _hexb(commit.block_id.hash)},
            "precommits": sum(v is not None for v in commit.precommits),
            "height": height,
        }

    def validators(self, params: dict) -> dict:
        vs = self.node.state.validators
        # snapshot the accum vector under the consensus lock: the commit
        # path rotates _accums in place, and an unlocked element-by-element
        # read can interleave with a rotation and report a mix of pre- and
        # post-increment priorities
        mtx = getattr(getattr(self.node, "consensus", None), "_mtx", None)
        if mtx is not None:
            with mtx:
                accums = vs._accums.copy()
        else:
            accums = vs._accums.copy()
        return {
            "block_height": self.node.state.last_block_height,
            "validators": [
                {"address": _hexb(v.address),
                 "pub_key": _hexb(v.pub_key.bytes_),
                 "voting_power": v.voting_power,
                 "accum": int(accums[i])}
                for i, v in enumerate(vs.validators)
            ],
        }

    def genesis(self, params: dict) -> dict:
        return {"genesis": json.loads(self.node.genesis_doc.to_json())}

    def dump_consensus_state(self, params: dict) -> dict:
        """Full RoundState + per-peer round states (reference
        `rpc/core/routes.go:21`, `rpc/core/consensus.go`)."""
        peer_states = {}
        sw = self.node.switch
        if sw is not None:
            for p in sw.peers():
                ps = p.get("consensus")
                if ps is not None:
                    peer_states[p.id] = ps.summary()
        return {"round_state": self.node.consensus.get_round_state_dump(),
                "peer_round_states": peer_states}

    def evidence(self, params: dict) -> dict:
        """Pending equivocation proofs from the evidence pool."""
        def vote_d(v):
            return {"validator": _hexb(v.validator_address),
                    "height": v.height, "round": v.round, "type": v.type,
                    "block_hash": _hexb(v.block_id.hash)}
        pool = getattr(self.node, "evidence_pool", None)
        if pool is None:
            return {"evidence": [], "count": 0}
        evs = pool.pending()
        return {"count": len(evs),
                "evidence": [{"vote_a": vote_d(e.vote_a),
                              "vote_b": vote_d(e.vote_b)} for e in evs]}

    # -- unsafe operator routes (reference rpc/core/routes.go:30-36) ------
    def unsafe_flush_mempool(self, params: dict) -> dict:
        self.node.mempool.flush()
        return {"flushed": True}

    def unsafe_dial_seeds(self, params: dict) -> dict:
        seeds = params.get("seeds") or []
        if isinstance(seeds, str):
            seeds = [s for s in seeds.split(",") if s]
        sw = self.node.switch
        if sw is None:
            raise ValueError("node has no p2p switch")
        for s in seeds:
            sw.dial_peer_async(NetAddress.parse(str(s)))
        return {"dialing": list(map(str, seeds))}

    # -- debug/profiling routes (reference pprof endpoints analog) --------
    def debug_stacks(self, params: dict) -> dict:
        return {"threads": trace.thread_stacks()}

    def debug_trace_start(self, params: dict) -> dict:
        """Start a `torch.profiler` capture of the card into
        `<tmp>/TRACE_BASE/<name>` (`name` a flat directory name)."""
        d = _flat_path(os.path.join(tempfile.gettempdir(), TRACE_BASE),
                       str(params.get("name") or "trace"), "trace name",
                       "trace name escapes the trace directory")
        return {"started": trace.start_device_trace(d), "dir": d}

    def debug_trace_stop(self, params: dict) -> dict:
        """Stop the capture; the trace is `trace.DEVICE_TRACE_FILE` in
        the returned directory."""
        return {"dir": trace.stop_device_trace()}

    def debug_flight_recorder(self, params: dict) -> dict:
        """Dump the in-process flight recorder.  format="chrome" returns
        the Chrome trace-event JSON (load in Perfetto / chrome://tracing);
        the default "spans" form is the raw oldest-first span list.
        name=SUBSTR keeps only matching spans, last=N the N most recent
        (filters apply server-side so a 16k-span ring doesn't cross the
        wire to answer a question about its tail).  clear=true empties
        the ring after the dump."""
        rec = tracing.RECORDER
        fmt = str(params.get("format", "spans"))
        name = str(params.get("name", "") or "")
        last = int(params.get("last", 0) or 0)

        def _filter(evs, ts_key="ts"):
            if name:
                evs = [e for e in evs if name in e.get("name", "")]
            if last > 0:
                evs = sorted(evs, key=lambda e: e.get(ts_key, 0))[-last:]
            return evs

        if fmt == "chrome":
            doc = rec.to_chrome_trace()
            if name or last:
                meta = [e for e in doc["traceEvents"]
                        if e.get("ph") == "M"]
                spans = [e for e in doc["traceEvents"]
                         if e.get("ph") != "M"]
                doc["traceEvents"] = _filter(spans) + meta
            out = {"trace": doc}
        elif fmt == "spans":
            out = {"spans": _filter(rec.snapshot())}
        else:
            raise ValueError("format must be 'spans' or 'chrome'")
        out.update({"total": rec.total, "dropped": rec.dropped,
                    "capacity": rec.capacity})
        if str(params.get("clear", "")).lower() in ("1", "true", "yes"):
            rec.clear()
        return out

    def debug_timeline(self, params: dict) -> dict:
        """This node's height-lifecycle dump for the mesh collector
        (telemetry/collector.merge_dumps): the canonical per-height
        records from the consensus core's ring, a wall-clock sample for
        cross-node skew normalization, and the local stage histogram.
        last=N keeps the N most recent heights."""
        cs = self.node.consensus
        records = list(cs.lifecycle)
        last = int(params.get("last", 0) or 0)
        if last > 0:
            records = records[-last:]
        return {"node": cs.node_id or self.node.config.base.moniker,
                "wall_now": time.time(),
                "records": records,
                "stage_seconds": REGISTRY.consensus_stage_seconds.snapshot()}

    def debug_doctor(self, params: dict) -> dict:
        """Pipeline attribution over the live flight recorder: per-window
        wall-clock partition (compile / transfer / device / scalar /
        idle) and the largest thief of the throughput target."""
        return {"report": attribution.doctor_report(
            tracing.RECORDER.snapshot())}

    def debug_bench_history(self, params: dict) -> dict:
        """Bench regression ledger entries with deltas vs best prior
        run.  The ledger path is an RPC param: restricted to a flat
        filename in the node's working directory (the containment rule
        of debug_trace_start)."""
        path = _flat_path(os.getcwd(),
                          str(params.get("ledger") or ledger.DEFAULT_PATH),
                          "ledger",
                          "ledger path escapes the working directory")
        entries = ledger.load(path)
        deltas = None
        if entries:
            deltas = ledger.compute_deltas(
                entries[:-1], entries[-1].get("configs") or {})
        return {"entries": entries, "count": len(entries),
                "latest_deltas": deltas}

    def net_info(self, params: dict) -> dict:
        sw = self.node.switch
        if sw is None:
            return {"listening": False, "peers": []}
        return sw.net_info()

    # -- mempool routes (reference rpc/core/mempool.go) ------------------
    def broadcast_tx_async(self, params: dict) -> dict:
        tx = _parse_tx(params)
        tx_hash = Tx(tx).hash
        threading.Thread(target=self.node.mempool.check_tx,
                         args=(tx, tx_hash), daemon=True).start()
        return {"hash": _hexb(tx_hash)}

    def broadcast_tx_sync(self, params: dict) -> dict:
        tx = _parse_tx(params)
        # hash once, share with admission: the response needs it either
        # way, and at flood rates the second sha256 (and even the Tx
        # wrapper allocation) is real budget
        tx_hash = merkle.leaf_hash(tx)
        res = self.node.mempool.check_tx(tx, tx_hash=tx_hash)
        if res is None:
            raise ValueError("tx already in cache")
        return {"code": res.code, "data": res.data.hex(),
                "log": res.log, "hash": tx_hash.hex()}

    def broadcast_tx_commit(self, params: dict) -> dict:
        """CheckTx then wait for the DeliverTx event
        (reference rpc/core/mempool.go:48-104)."""
        tx = _parse_tx(params)
        tx_hash = Tx(tx).hash
        done = threading.Event()
        result: dict = {}

        def on_deliver(tx_event):
            result["deliver"] = tx_event
            done.set()

        key = event_tx(tx_hash)
        sub_id = f"btc-{tx_hash.hex()[:16]}"
        self.node.evsw.subscribe(sub_id, key, on_deliver)
        try:
            check = self.node.mempool.check_tx(tx, tx_hash=tx_hash)
            if check is None:
                raise ValueError("tx already in cache")
            if not check.is_ok:
                return {"check_tx": _result_dict(check),
                        "hash": _hexb(tx_hash), "height": 0}
            if not done.wait(BROADCAST_TX_COMMIT_TIMEOUT):
                raise TimeoutError("timed out waiting for tx commit")
            ev = result["deliver"]
            return {"check_tx": _result_dict(check),
                    "deliver_tx": _result_dict(ev.result),
                    "hash": _hexb(tx_hash), "height": ev.height}
        finally:
            self.node.evsw.unsubscribe(sub_id, key)

    def unconfirmed_txs(self, params: dict) -> dict:
        txs = self.node.mempool.reap(-1)
        return {"n_txs": len(txs), "txs": [_hexb(t) for t in txs]}

    def num_unconfirmed_txs(self, params: dict) -> dict:
        return {"n_txs": self.node.mempool.size(),
                "total_bytes": self.node.mempool.size_bytes()}

    def tx(self, params: dict) -> dict:
        """Tx lookup by hash (kv indexer required)."""
        h = params.get("hash", "")
        if h.startswith("0x"):
            h = h[2:]
        tr = self.node.tx_indexer.get(bytes.fromhex(h))
        if tr is None:
            raise ValueError(f"tx {h} not found")
        return {"height": tr.height, "index": tr.index,
                "tx": _hexb(tr.tx), "tx_result": _result_dict(tr.result)}
