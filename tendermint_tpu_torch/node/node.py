"""Node: the composition root wiring every subsystem together.

Reference: `node/node.go` — `NewNode` (`:68-236`) builds DBs, state,
handshake, proxy app conns, mempool, consensus, reactors, switch, and RPC;
`OnStart` (`:238-271`) brings up the listener, reactors, and RPC servers;
`RunForever` (`:288`).

Copy of `tendermint_tpu/node/node.py` with the port's rules:

* The crypto backend is explicit.  The node builds it from
  `base.crypto_backend` (`make_backend`) unless one is passed in, and
  hands one `BatchPlane` over it to the mempool and the consensus state;
  the blockchain reactor and the handshake verify on the backend itself.
  The JAX node installs a process-wide backend instead.
* Nothing hides the card or a fault.  No comb-table warmer runs in a
  daemon thread (the first verify builds the tables), the node does not
  run solo when a p2p listen address is set, `rpc.grpc_laddr` and
  `crypto.supervised` are refused (the gRPC transport and the supervised
  ladder are not ported), and `stop()` raises the fault kept by the
  switch (its reactors') or the consensus state.  `run_forever` stops the
  node, and so raises, as soon as one of them holds a fault.
* `status` has no `metrics` and no `crypto_supervisor` keys until the
  metrics and the supervised ladder are ported.
"""

from __future__ import annotations

import logging
import os
import threading

from tendermint_tpu_torch import __version__
from tendermint_tpu_torch.batchplane import BatchPlane
from tendermint_tpu_torch.blockchain.store import BlockStore
from tendermint_tpu_torch.config import CRYPTO_BACKENDS, Config
from tendermint_tpu_torch.consensus.replay import Handshaker
from tendermint_tpu_torch.consensus.state import ConsensusState
from tendermint_tpu_torch.crypto.backend import CudaBackend, PythonBackend
from tendermint_tpu_torch.mempool.mempool import Mempool
from tendermint_tpu_torch.node.p2p_setup import build_p2p
from tendermint_tpu_torch.proxy import ClientCreator
from tendermint_tpu_torch.rpc.server import RPCServer
from tendermint_tpu_torch.state.evidence import EvidencePool
from tendermint_tpu_torch.state.state import get_state
from tendermint_tpu_torch.state.txindex import KVTxIndexer
from tendermint_tpu_torch.types import GenesisDoc, PrivValidator
from tendermint_tpu_torch.types.events import EventSwitch
from tendermint_tpu_torch.types.tx import Tx
from tendermint_tpu_torch.utils.db import new_db

log = logging.getLogger(__name__)


def make_backend(name: str):
    """The backend `base.crypto_backend` names: "cuda" the kernels on the
    card (raises without one), "cpu" their plain PyTorch versions,
    "python" the golden bigint verifier."""
    if name == "cuda":
        return CudaBackend()
    if name == "cpu":
        return CudaBackend(device="cpu")
    if name == "python":
        return PythonBackend()
    raise ValueError(
        f"crypto_backend {name!r} is not one of the port's backends "
        f"{CRYPTO_BACKENDS}; the JAX package's tpu and native rungs come "
        "with the crypto ladder (ROADMAP A.2)")


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
        if config.crypto.supervised:
            raise ValueError("crypto.supervised: the supervised crypto "
                             "ladder is not ported (ROADMAP A.2)")
        if config.rpc.grpc_laddr:
            raise ValueError(
                f"rpc.grpc_laddr {config.rpc.grpc_laddr!r}: the gRPC "
                "server is not ported; it waits until grpcio is on the "
                "card's machine (ROADMAP A.4)")
        self.backend = (backend if backend is not None
                        else make_backend(base.crypto_backend))
        self.plane = BatchPlane(self.backend)

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
            app if app is not None else base.proxy_app).new_app_conns()
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
                log.info("mempool wal recovered %d txs", n)
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
                    log.error("stopping on a fault: %r", self.fault())
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
        }
