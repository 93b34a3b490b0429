"""Startup handshake: reconcile app height vs block store vs state.

Reference: `consensus/replay.go` — `Handshake` (`:222-247`) queries the
app's Info, then `ReplayBlocks` (`:251-322`) walks the decision table at
`:263-318`:

  store == state:      app may be behind -> replay app-missing blocks via
                       exec_commit_block (no state mutation)
  store == state + 1:  a block was saved but state not updated —
        app < state:   replay app to state, then ApplyBlock(store) mutating
        app == state:  ApplyBlock(store) against the real app
        app == store:  app already committed: apply saved ABCIResponses
                       against a mock app (`:385-420`) so state catches up
                       without re-executing

Copy of `tendermint_tpu/consensus/replay.py`: the handshake and the WAL
`Playback` console.  The stored block applied in the store == state + 1
cases has its LastCommit verified through the `backend` the handshaker is
given, or not at all with None (blocks whose commits fast-sync verified
before storing them).  `Playback` verifies through the batch plane it is
given, as a live `ConsensusState` does.
"""

from __future__ import annotations

import struct

from tendermint_tpu_torch import config as config_mod
from tendermint_tpu_torch.abci.app import Application
from tendermint_tpu_torch.abci.types import (ResponseEndBlock, Result,
                                             Validator as ABCIValidator)
from tendermint_tpu_torch.blockchain.store import BlockStore
from tendermint_tpu_torch.consensus import messages as M
from tendermint_tpu_torch.consensus.state import ConsensusState, PlaneFault
from tendermint_tpu_torch.consensus.ticker import TimeoutInfo
from tendermint_tpu_torch.consensus.wal import (REC_ENDHEIGHT, REC_MESSAGE,
                                                REC_TIMEOUT, WAL)
from tendermint_tpu_torch.mempool.mempool import Mempool
from tendermint_tpu_torch.proxy import ClientCreator
from tendermint_tpu_torch.state import execution
from tendermint_tpu_torch.state.state import State, get_state
from tendermint_tpu_torch.utils.db import MemDB
from tendermint_tpu_torch.utils.log import get_logger

log = get_logger("replay")


class _MockReplayApp(Application):
    """Replays saved ABCIResponses (reference `:385-420`): DeliverTx
    returns the recorded results, Commit returns the app's current hash."""

    def __init__(self, app_hash: bytes, abci_responses):
        self.app_hash = app_hash
        self.responses = abci_responses
        self._i = 0

    def deliver_tx(self, tx: bytes) -> Result:
        res = self.responses.deliver_txs[self._i]
        self._i += 1
        return res

    def end_block(self, height: int) -> ResponseEndBlock:
        return ResponseEndBlock(diffs=[
            ABCIValidator(pub, power)
            for pub, power in self.responses.end_block_diffs])

    def commit(self) -> Result:
        return Result(0, data=self.app_hash)


class Handshaker:
    def __init__(self, state: State, block_store, backend=None):
        self.state = state
        self.store = block_store
        self.backend = backend
        self.n_blocks = 0

    def handshake(self, proxy_app) -> bytes:
        """Align the app with the store/state; returns the app hash the
        node should trust (reference `:222-247`)."""
        info = proxy_app.query.info()
        app_height = info.last_block_height
        app_hash = info.last_block_app_hash
        return self.replay_blocks(proxy_app, app_hash, app_height)

    def replay_blocks(self, proxy_app, app_hash: bytes,
                      app_height: int) -> bytes:
        state = self.state
        store_height = self.store.height
        state_height = state.last_block_height

        if app_height == 0:
            validators = [ABCIValidator(gv.pub_key, gv.power)
                          for gv in state.genesis_doc.validators]
            proxy_app.consensus.init_chain(validators)

        if store_height == 0:
            return app_hash

        if store_height < state_height or \
                store_height > state_height + 1 or \
                app_height > store_height:
            raise RuntimeError(
                f"unrecoverable heights: store {store_height} state "
                f"{state_height} app {app_height}")

        if store_height == state_height:
            # app may lag: replay without state mutation (reference :282-292)
            app_hash = self._replay_range(proxy_app, app_height, store_height,
                                          app_hash=app_hash)
            if app_hash != state.app_hash:
                raise RuntimeError(
                    f"app hash {app_hash.hex()} != state "
                    f"{state.app_hash.hex()} after replay")
            return app_hash

        # store_height == state_height + 1
        if app_height < state_height:
            app_hash = self._replay_range(proxy_app, app_height, state_height,
                                          app_hash=app_hash)
            return self._apply_stored(proxy_app, store_height)
        if app_height == state_height:
            return self._apply_stored(proxy_app, store_height)
        # app_height == store_height: state catches up via saved responses
        resp = state.load_abci_responses(store_height)
        if resp is None:
            raise RuntimeError(
                f"no saved ABCIResponses for height {store_height}")
        mock = ClientCreator(_MockReplayApp(app_hash, resp)).new_app_conns()
        self._apply_stored(mock, store_height)
        return app_hash

    def _replay_range(self, proxy_app, from_height: int, to_height: int,
                      app_hash: bytes) -> bytes:
        for h in range(from_height + 1, to_height + 1):
            block = self.store.load_block(h)
            if block is None:
                raise RuntimeError(f"missing block {h} in store")
            app_hash = execution.exec_commit_block(proxy_app.consensus, block)
            self.n_blocks += 1
        return app_hash

    def _apply_stored(self, proxy_app, height: int) -> bytes:
        """ApplyBlock for the stored block at `height`, mutating state."""
        block = self.store.load_block(height)
        meta = self.store.load_block_meta(height)
        if block is None or meta is None:
            raise RuntimeError(f"missing block {height} in store")
        execution.apply_block(self.state, proxy_app.consensus, block,
                              meta.block_id.parts, execution.MockMempool(),
                              self.backend)
        self.n_blocks += 1
        return self.state.app_hash


class Playback:
    """Replay-console playback manager (reference
    `consensus/replay_file.go:76-141`): drives a fresh ConsensusState from
    a consensus WAL record by record, with seek-back and run-until.

    "back" is not expressible in the state machine (reference comment at
    `:117` — replays can only be reset to the beginning), so `back(n)`
    rebuilds a fresh ConsensusState from genesis and re-feeds
    `count - n` records, exactly the reference's `replayReset`.  Each
    block's LastCommit is verified on `plane`.
    """

    def __init__(self, genesis, wal_path: str, plane,
                 proxy_app: str = "kvstore", cfg=None):
        self.genesis = genesis
        self.plane = plane
        self.proxy_app = proxy_app
        self.cfg = cfg or config_mod.test_config().consensus
        self.records = WAL.read_all(wal_path)
        self.count = 0
        self.cs = self._fresh_cs()

    def _fresh_cs(self) -> ConsensusState:
        conns = ClientCreator(self.proxy_app).new_app_conns()
        st = get_state(MemDB(), self.genesis)
        cs = ConsensusState(self.cfg, st, conns.consensus,
                            BlockStore(MemDB()),
                            Mempool(conns.mempool, plane=self.plane),
                            self.plane)
        cs._replay_mode = True      # never writes a WAL, never signs
        return cs

    def _feed_one(self, kind: int, payload: bytes) -> None:
        try:
            if kind == REC_MESSAGE:
                self.cs._handle_msg(M.decode_msg(payload), "")
            elif kind == REC_TIMEOUT:
                h, r, s = struct.unpack(">QIB", payload)
                self.cs._handle_timeout(TimeoutInfo(h, r, s))
            # ENDHEIGHT markers carry no input to the machine
        except PlaneFault:
            raise
        except Exception:
            log.exception("error replaying WAL record")

    def next(self, n: int = 1) -> int:
        """Feed the next n records; returns how many were fed."""
        fed = 0
        while fed < n and self.count < len(self.records):
            self._feed_one(*self.records[self.count])
            self.count += 1
            fed += 1
        return fed

    def back(self, n: int = 1) -> None:
        """Rebuild from genesis and re-feed count-n records (reference
        `replayReset`)."""
        target = max(0, self.count - n)
        self.cs = self._fresh_cs()
        self.count = 0
        self.next(target)

    def run_until(self, height: int) -> None:
        """Feed records until the ENDHEIGHT marker for `height` (i.e.
        the machine has fully committed that height) or EOF."""
        while self.count < len(self.records):
            kind, payload = self.records[self.count]
            self._feed_one(kind, payload)
            self.count += 1
            if kind == REC_ENDHEIGHT and \
                    struct.unpack(">Q", payload)[0] >= height:
                return

    def round_state(self, what: str = "") -> str:
        """Inspection (reference console `rs [short|...]`)."""
        rs = self.cs.get_round_state()
        if what == "short" or what == "":
            return f"{rs.height}/{rs.round}/{rs.step}"
        if what == "validators":
            return str([v.address.hex()[:12]
                        for v in rs.validators.validators])
        if what == "proposal":
            return str(rs.proposal)
        if what == "proposal_block":
            return (f"parts={rs.proposal_block_parts} "
                    f"block={rs.proposal_block is not None}")
        if what == "locked_round":
            return str(rs.locked_round)
        if what == "locked_block":
            return str(rs.locked_block is not None)
        if what == "votes":
            return str(rs.votes)
        return f"unknown field {what!r}"
