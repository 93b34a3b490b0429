"""Driver of the fast-sync path: a node catching up on a chain.

Each pass is what a node does on joining: it receives the chain's blocks
as wire bytes and decodes them (`Block.decode_bytes`), with each block's
seen commit in array form; then, on a fresh state, kvstore app and
`BlockStore` on `MemDB`, it replays the honest blocks through
`replay_pipelined` (K1 dispatched up to the pipeline's depth ahead of
the applied window, every block stored before it is applied), and then
the tip as each faulty peer serves it, decoded afresh from its wire
bytes, whose seen commits carry a forged signature, which the node must
refuse.  The window of a run is whole passes, the last one stopped by
`stop_when` when the time is up.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

from tendermint_tpu_torch.blockchain import replay as rp
from tendermint_tpu_torch.blockchain.store import BlockStore
from tendermint_tpu_torch.proxy import ClientCreator
from tendermint_tpu_torch.state.state import get_state
from tendermint_tpu_torch.types import (Block, BlockID, CompactCommit,
                                        GenesisDoc, GenesisValidator)
from tendermint_tpu_torch.types.part_set import PartSetHeader
from tendermint_tpu_torch.utils.db import MemDB

from bftbench.drivers import verdict
from bftbench.reference import judge
from bftbench.traffic.chain import GENESIS_TIME_NS

E2E = "blocks_per_s"
UNITS = {E2E: "blocks/s"}


@dataclass
class Pass:
    decode_s: float = 0.0
    decoded: int = 0
    replay: object = None          # the honest call's PipelineResult
    complete: bool = False         # the tip was judged
    error: tuple | None = None     # (type, height, lane) the honest replay
    tip_errors: list = field(default_factory=list)  # per tip, the same
    height: int = 0
    app_hash: bytes = b""
    last_block_id: tuple = ()
    store: object = None
    tallied: int = 0
    spans: list = field(default_factory=list)   # harness spans


class Driver:
    """Runs passes of `traffic` (a `traffic.chain.SyncChain`) through the
    program on `backend`."""

    def __init__(self, traffic, config: dict, backend):
        self.t = traffic
        self.config = config
        self.backend = backend
        self.genesis = GenesisDoc(
            chain_id=traffic.chain_id,
            validators=[GenesisValidator(p, traffic.power)
                        for p in traffic.pubs],
            genesis_time_ns=GENESIS_TIME_NS)
        self.present = np.ones(len(traffic.pubs), bool)

    def _receive(self, lo: int, hi: int, sigs) -> tuple:
        """Heights lo+1 .. hi as a node receives them: blocks decoded from
        their wire bytes, seen commits in array form with `sigs`
        (uint8[hi - lo, V, 64])."""
        t = self.t
        blocks = [Block.decode_bytes(w) for w in t.wire[lo:hi]]
        commits = [CompactCommit(BlockID(t.block_hash[h], PartSetHeader(
            *t.parts[h])), h + 1, 0, sigs[h - lo], self.present)
            for h in range(lo, hi)]
        return blocks, commits

    def run_pass(self, deadline: float | None = None,
                 window: int | None = None, stop=None) -> Pass:
        """One pass; `window` and `stop` (a `stop_when`) replace the
        configuration's window and the deadline's stop for a warm-up."""
        t, p = self.t, Pass()
        if stop is None and deadline is not None:
            stop = lambda: time.perf_counter() >= deadline  # noqa: E731
        n = t.blocks
        a = time.perf_counter()
        blocks, commits = self._receive(0, n, t.sigs)
        b = time.perf_counter()
        p.decode_s, p.decoded = b - a, len(blocks)
        p.spans.append(("decode", a, b))
        state = get_state(MemDB(), self.genesis)
        conns = ClientCreator(self.config["app"]).new_app_conns()
        p.store = BlockStore(MemDB())
        c = time.perf_counter()
        p.spans.append(("pass.fresh_state", b, c))
        try:
            p.replay = rp.replay_pipelined(
                state, conns.consensus, blocks, commits, self.backend,
                window=window or t.window, store=p.store, stop_when=stop)
        except ValueError as e:     # the commit errors name height, lane
            p.error = verdict(e)
        d = time.perf_counter()
        p.spans.append(("replay", c, d))
        if p.replay is not None:
            p.tallied = sum(sum(w.tallied) for w in p.replay.windows)
        if p.error is None and state.last_block_height == n and \
                (deadline is None or d < deadline):
            for sigs in t.tip_sigs:     # each faulty peer's tip in turn
                e0 = time.perf_counter()
                tip, tip_commits = self._receive(n, t.heights, sigs)
                e1 = time.perf_counter()
                p.decode_s += e1 - e0
                p.decoded += len(tip)
                p.spans.append(("decode", e0, e1))
                err = None
                try:
                    rp.replay_pipelined(state, conns.consensus, tip,
                                        tip_commits, self.backend,
                                        window=t.window, store=p.store)
                except ValueError as e:
                    err = verdict(e)
                p.tip_errors.append(err)
                p.spans.append(("tip", e1, time.perf_counter()))
            p.complete = True
        p.height = state.last_block_height
        p.app_hash = state.app_hash
        bid = state.last_block_id
        p.last_block_id = (bid.hash, bid.parts.total, bid.parts.hash)
        return p

    def step(self, deadline: float) -> Pass:
        return self.run_pass(deadline)

    def warm(self) -> None:
        """The set's tables (K2) and every launch's shape, without a whole
        pass's apply: the honest replay cut into windows of the tip's
        length (K1 and the part sets at the tip's shape, up to the
        pipeline's depth of them), then in the configuration's windows,
        each stopped after one applied block."""
        once = lambda: True  # noqa: E731
        self.run_pass(window=self.t.heights - self.t.blocks, stop=once)
        self.run_pass(stop=once)

    def close(self) -> None:
        pass

    def judge(self, passes: list, rng) -> tuple:
        outputs = self.outputs(passes, lambda i, h: judge.sync_heights(
            rng, h, self.t.heights))
        return judge.judge_sync(self.t, outputs, rng)

    @staticmethod
    def end_to_end(passes: list, window_s: float) -> dict:
        return {E2E: sum(p.height for p in passes) / window_s}

    def host_spans(self, passes: list) -> list:
        return [s for p in passes for s in p.spans]

    def outputs(self, passes: list, heights_of) -> list:
        """What each pass produced, as plain values for the reference:
        its verdict, height, app hash, last block ID and tallied power,
        and for the stored heights `heights_of(pass index, height)` picks,
        the store's block meta, block bytes and seen-commit signatures."""
        out = []
        for i, p in enumerate(passes):
            stored = {}
            for h in heights_of(i, p.height):
                meta = p.store.load_block_meta(h)
                block = p.store.load_block(h)
                seen = p.store.load_seen_commit(h)
                stored[h] = (
                    None if meta is None else (
                        meta.block_id.hash, meta.block_id.parts.total,
                        meta.block_id.parts.hash),
                    None if block is None else block.encode(),
                    None if seen is None else [
                        None if v is None else v.signature
                        for v in seen.precommits])
            out.append({"complete": p.complete, "error": p.error,
                        "tip_errors": p.tip_errors,
                        "height": p.height, "app_hash": p.app_hash,
                        "last_block_id": p.last_block_id,
                        "tallied": p.tallied, "store_height": p.store.height,
                        "stored": stored})
        return out
