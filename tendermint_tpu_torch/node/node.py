"""Node: the composition root wiring every subsystem together.

Reference: `node/node.go` — `NewNode` (`:68-236`) builds DBs, state,
handshake, proxy app conns, mempool, consensus, reactors, switch, and RPC;
`OnStart` (`:238-271`) brings up the listener, reactors, and RPC servers;
`RunForever` (`:288`).

Copy of `tendermint_tpu/node/node.py` with the port's rules:

* The crypto backend is explicit.  The node builds it from
  `base.crypto_backend` and `crypto` (`make_backend`: with
  `crypto.supervised` the ladder of `crypto.supervised`) unless one is
  passed in, and hands one `BatchPlane` over it to the mempool and the
  consensus state; the blockchain reactor and the handshake verify on the
  backend itself.  The JAX node installs a process-wide backend instead.
* Nothing hides the card or a fault.  No comb-table warmer runs in a
  daemon thread: the first verify reads the set's tables from the home's
  on-disk cache (`BaseConfig.table_cache_dir()`, which `cli init
  --warm-crypto` fills; off on a memdb node) and builds them (K2) only on
  a miss.  The node does not
  run solo when a p2p listen address is set, `rpc.grpc_laddr` without
  grpcio raises at start naming it (the JAX node warns and runs without
  the gRPC server), and `stop()` raises the fault kept
  by the switch (its reactors') or the consensus state.  `run_forever`
  stops the node, and so raises, as soon as one of them holds a fault.
  A demotion down the supervised ladder is counted in its
  `supervisor_status`, which `status` reports as `crypto_supervisor`.
* The node applies `base.log_level` (`utils/log.set_level_spec`) and
  names its backend in the metrics' build info; `status` carries
  `metrics` (the process-wide `utils/metrics` snapshot), and the RPC
  server serves `GET /metrics` and, behind `rpc.unsafe`, the tracing and
  telemetry routes.
* The persistent kvstore takes its file as an argument
  (`<data dir>/kvstore_app.json`, `home_app`); no `TM_KVSTORE_PATH`.
"""

from __future__ import annotations

import os
import threading

from tendermint_tpu_torch import __version__
from tendermint_tpu_torch.batchplane import BatchPlane
from tendermint_tpu_torch.blockchain.store import BlockStore
from tendermint_tpu_torch.abci.apps.kvstore import PersistentKVStoreApp
from tendermint_tpu_torch.config import (CRYPTO_BACKENDS, BaseConfig, Config,
                                         CryptoConfig)
from tendermint_tpu_torch.consensus.replay import Handshaker
from tendermint_tpu_torch.consensus.state import ConsensusState
from tendermint_tpu_torch.crypto.supervised import (SupervisedBackend,
                                                    make_rung)
from tendermint_tpu_torch.mempool.mempool import Mempool
from tendermint_tpu_torch.node.p2p_setup import build_p2p
from tendermint_tpu_torch.proxy import ClientCreator
from tendermint_tpu_torch.rpc.grpc_server import GRPCServer, require_grpc
from tendermint_tpu_torch.rpc.routes import Routes
from tendermint_tpu_torch.rpc.server import RPCServer
from tendermint_tpu_torch.state.evidence import EvidencePool
from tendermint_tpu_torch.state.state import get_state
from tendermint_tpu_torch.state.txindex import KVTxIndexer
from tendermint_tpu_torch.types import GenesisDoc, PrivValidator
from tendermint_tpu_torch.types.events import EventSwitch
from tendermint_tpu_torch.types.tx import Tx
from tendermint_tpu_torch.utils import metrics
from tendermint_tpu_torch.utils.db import new_db
from tendermint_tpu_torch.utils.log import set_level_spec
from tendermint_tpu_torch.utils.log import get_logger

log = get_logger("node")


def make_backend(name: str, crypto: CryptoConfig | None = None,
                 table_cache_dir: str | None = None):
    """The backend `base.crypto_backend` names: "cuda" the kernels on the
    card (raises without one), "cpu" their plain PyTorch versions,
    "native" the C++ host rung, "python" the golden bigint verifier.  With
    `crypto.supervised` set, the supervised ladder from that rung down to
    the python floor (`SupervisedBackend.build`, which raises when a rung
    fails to construct).  `table_cache_dir` is the kernel rungs' on-disk
    comb-table cache (`BaseConfig.table_cache_dir()` for a home; None:
    off)."""
    if name not in CRYPTO_BACKENDS:
        raise ValueError(
            f"crypto_backend {name!r} is not one of the port's backends "
            f"{CRYPTO_BACKENDS}")
    if crypto is not None and crypto.supervised:
        return SupervisedBackend.build(
            name, table_cache_dir=table_cache_dir,
            breaker_threshold=crypto.breaker_threshold,
            breaker_cooldown_s=crypto.breaker_cooldown_s,
            call_timeout_s=crypto.call_timeout_s, retries=crypto.retries,
            spot_check_every=crypto.spot_check_every)
    return make_rung(name, table_cache_dir)


PERSISTENT_APPS = ("persistent_kvstore", "persistent_dummy")


def home_app(base: BaseConfig):
    """`base.proxy_app` as `ClientCreator` takes it: a persistent kvstore
    as an instance on `<data dir>/kvstore_app.json`, any other spec as
    it is."""
    if base.proxy_app in PERSISTENT_APPS:
        os.makedirs(base.db_dir(), exist_ok=True)
        return PersistentKVStoreApp(
            os.path.join(base.db_dir(), "kvstore_app.json"))
    return base.proxy_app


class Node:
    def __init__(self, config: Config,
                 priv_validator: PrivValidator | None = None,
                 genesis_doc: GenesisDoc | None = None,
                 app=None, backend=None):
        """Build everything (reference `NewNode` node/node.go:68-236).

        `app` overrides config.base.proxy_app with an Application instance
        (in-process custom apps, tests); `backend` overrides
        config.base.crypto_backend.
        """
        self.config = config
        base = config.base
        set_level_spec(base.log_level)
        if config.rpc.grpc_laddr:
            require_grpc(f"rpc.grpc_laddr {config.rpc.grpc_laddr!r}")
        self.backend = (backend if backend is not None
                        else make_backend(
                            base.crypto_backend, config.crypto,
                            table_cache_dir=(base.table_cache_dir()
                                             if base.db_backend != "memdb"
                                             else None)))
        self.plane = BatchPlane(self.backend)
        metrics.set_build_info(crypto_backend=(
            f"supervised:{base.crypto_backend}"
            if self.backend.name == "supervised" else self.backend.name))

        # --- storage (reference :70-77) ---
        if base.db_backend == "memdb":
            mk = lambda name: new_db("memdb")        # noqa: E731
        else:
            os.makedirs(base.db_dir(), exist_ok=True)
            mk = lambda name: new_db(                # noqa: E731
                "sqlite", os.path.join(base.db_dir(), name + ".db"))
        self.block_store_db = mk("blockstore")
        self.state_db = mk("state")

        # --- genesis + state (reference :78) ---
        self.genesis_doc = genesis_doc or GenesisDoc.load(base.genesis_file())
        initial_state = get_state(self.state_db, self.genesis_doc)
        self.block_store = BlockStore(self.block_store_db)

        # --- priv validator ---
        self.priv_validator = priv_validator
        if self.priv_validator is None and base.db_backend != "memdb":
            self.priv_validator = PrivValidator.load_or_generate(
                base.priv_validator_file())

        # --- app conns + handshake (reference :83-89) ---
        self.proxy_app = ClientCreator(
            app if app is not None else home_app(base)).new_app_conns()
        self.handshaker = Handshaker(initial_state, self.block_store,
                                     self.backend)
        self.handshaker.handshake(self.proxy_app)

        # --- events, mempool, tx index, consensus (reference :96-158) ---
        self.evsw = EventSwitch()
        mempool_wal = (os.path.join(base.db_dir(), "mempool.wal")
                       if base.db_backend != "memdb" else "")
        self.mempool = Mempool(self.proxy_app.mempool, config.mempool,
                               wal_path=mempool_wal, plane=self.plane)
        self.tx_indexer = KVTxIndexer(mk("tx_index"))
        if mempool_wal:
            # the tx index says which journalled txs already committed —
            # don't re-admit those (kvstore-style apps accept replays)
            n = self.mempool.recover_wal(
                committed=lambda tx: self.tx_indexer.get(Tx(tx).hash)
                is not None)
            if n:
                log.info("mempool wal recovered", txs=n)
        wal_path = (os.path.join(base.db_dir(), "cs.wal")
                    if base.db_backend != "memdb" else "")
        self.consensus = ConsensusState(
            config.consensus, initial_state, self.proxy_app.consensus,
            self.block_store, self.mempool, self.plane,
            priv_validator=self.priv_validator, evsw=self.evsw,
            wal_path=wal_path, tx_indexer=self.tx_indexer,
            node_id=base.moniker)

        # --- evidence pool (equivocation proofs) ---
        self.evidence_pool = EvidencePool(mk("evidence"),
                                          self.genesis_doc.chain_id)
        self.evsw.subscribe(
            "node-evidence", "EvidenceDoubleSign",
            lambda ev: self.evidence_pool.add(
                ev, self._valset_at(ev.vote_a.height)))

        # --- p2p switch (built when a listen addr is configured;
        # reference runs alone with fast_sync off, node/node.go:117-125) ---
        self.switch = None
        if config.p2p.laddr:
            self.switch = build_p2p(self)

        # --- RPC ---
        self.rpc_server = None
        self.grpc_server = None
        self._stopped = threading.Event()

    def _valset_at(self, height: int):
        """The validator set that signed votes at `height`: from saved
        history when available (evidence can arrive after an EndBlock
        membership change), else the live set."""
        st = self.consensus.state
        vs = st.load_validators(height)
        return vs if vs is not None else st.validators

    @property
    def state(self):
        """The LIVE state: consensus swaps in a fresh State copy on every
        commit, so RPC must read through it rather than hold the boot-time
        object."""
        return self.consensus.state

    # -- lifecycle ------------------------------------------------------
    def start(self) -> None:
        """Reference `OnStart` node/node.go:238-271."""
        if self.switch is not None:
            self.switch.start()   # reactors own consensus startup
        else:
            self.consensus.start()
        if self.config.rpc.laddr:
            self.rpc_server = RPCServer(self, self.config.rpc)
            self.rpc_server.start()
        if self.config.rpc.grpc_laddr:
            self.grpc_server = GRPCServer(Routes(self),
                                          self.config.rpc.grpc_laddr)
            self.grpc_server.start()

    def fault(self) -> BaseException | None:
        """The first fault kept by the switch, one of its reactors or the
        consensus state, else None."""
        held = [self.consensus.fault]
        if self.switch is not None:
            held += [self.switch.fault] + [
                getattr(r, "fault", None)
                for r in self.switch._reactors.values()]
        return next((f for f in held if f is not None), None)

    def stop(self) -> None:
        """Stop every part, then raise the fault the switch (after its
        reactors, the consensus state's among them) or the consensus
        state raised on stop."""
        self._stopped.set()
        if self.rpc_server is not None:
            self.rpc_server.stop()
        if self.grpc_server is not None:
            self.grpc_server.stop()
        try:
            if self.switch is not None:
                self.switch.stop()
            else:
                self.consensus.stop()
        finally:
            self.plane.stop()
            self.mempool.close()

    def run_forever(self) -> None:
        """Reference `RunForever` node/node.go:288: run until SIGINT or
        until a part of the node holds a fault; either way stop, which
        raises the fault."""
        try:
            while not self._stopped.wait(0.5):
                if self.fault() is not None:
                    log.error("stopping on a fault", error=repr(self.fault()))
                    break
            else:
                return                   # stopped by another caller
        except KeyboardInterrupt:
            pass
        self.stop()

    # -- introspection for RPC ------------------------------------------
    def status(self) -> dict:
        latest_height = self.block_store.height
        meta = self.block_store.load_block_meta(latest_height) \
            if latest_height else None
        return {
            "node_info": {
                "moniker": self.config.base.moniker,
                "network": self.state.chain_id,
                "version": __version__,
            },
            "pub_key": (self.priv_validator.pub_key.hex()
                        if self.priv_validator else None),
            "latest_block_height": latest_height,
            "latest_block_hash": (meta.block_id.hash.hex() if meta else ""),
            "latest_app_hash": self.state.app_hash.hex(),
            "validator_count": self.state.validators.size(),
            "consensus": self.consensus.get_round_state_summary(),
            "metrics": metrics.snapshot(),
        } | self._crypto_status()

    def _crypto_status(self) -> dict:
        fn = getattr(self.backend, "supervisor_status", None)
        return {"crypto_supervisor": fn()} if fn is not None else {}
