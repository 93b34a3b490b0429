"""Mempool ingress end to end: the port's signed-tx admission slice.

A pre-built corpus (`loadgen.build_corpus`) is offered once per entry,
round by round, through a `broadcast_tx_sync`-shaped handler into
`Mempool.check_tx` from many threads; the batch plane coalesces the
signature lanes into raw verifies (kernel K5 on `CudaBackend`).  While a
round is ingested, the validators' prevotes for the last block ride the
same plane in the consensus class (grouped verify, kernel K1 with
per-lane keys).  After each round, one block of `mempool.reap` is made
at the next height and applied by `execution.apply_window` with the real
mempool, so `Mempool.update` drops the committed txs and rechecks the
rest.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

import numpy as np

from tendermint_tpu_torch.batchplane import BatchPlane, CLASS_CONSENSUS
from tendermint_tpu_torch.blockchain.replay import make_block
from tendermint_tpu_torch.config import MempoolConfig
from tendermint_tpu_torch.crypto import pure_ed25519 as ref
from tendermint_tpu_torch.mempool.mempool import Mempool
from tendermint_tpu_torch.proxy import ClientCreator
from tendermint_tpu_torch.scenarios import loadgen
from tendermint_tpu_torch.state import execution
from tendermint_tpu_torch.state.state import get_state
from tendermint_tpu_torch.types import (GenesisDoc, GenesisValidator,
                                        canonical)
from tendermint_tpu_torch.utils.db import MemDB

MAX_BLOCK_TXS = 10_000        # reference ConsensusConfig.max_block_size_txs
CHAIN_ID = "mempool-chain"


@dataclass
class IngressRun:
    results: list = field(default_factory=list)  # (outcome, s) per entry
    blocks: list = field(default_factory=list)
    votes: list = field(default_factory=list)    # bool[V] per vote burst
    flushes: list = field(default_factory=list)  # (kind, reason, lanes)
    ingress_s: float = 0.0    # submission wall time, workers started
    apply_s: float = 0.0      # making and applying the blocks
    state: object = None
    mempool: Mempool | None = None


def run_ingress(backend, corpus: list[dict], *, round_size: int,
                workers: int, n_vals: int, target_lanes: int = 1024,
                waits: dict[str, float] | None = None) -> IngressRun:
    """Offer `corpus` in rounds of `round_size` from `workers` threads to
    a kvstore chain of `n_vals` validators (seed bytes [1, i+1] + 30
    zeros, power 10), one block per round.  The mempool runs on
    `MempoolConfig()` and a `BatchPlane` over `backend` (its defaults
    unless `target_lanes` / `waits` say otherwise)."""
    seeds = [bytes([1, i + 1]) + b"\0" * 30 for i in range(n_vals)]
    by_pub = {ref.pubkey_from_seed(x): x for x in seeds}
    genesis = GenesisDoc(chain_id=CHAIN_ID, genesis_time_ns=1_000_000_000,
                         validators=[GenesisValidator(p, 10)
                                     for p in by_pub])
    state = get_state(MemDB(), genesis)
    vals = state.validators
    seeds = [by_pub[v.pub_key.bytes_] for v in vals.validators]
    conns = ClientCreator("kvstore").new_app_conns()
    run = IngressRun(state=state)
    plane = BatchPlane(backend, target_lanes=target_lanes, waits=waits,
                       on_flush=lambda k, r, n, _p: run.flushes.append(
                           (k, r, n)))
    run.mempool = Mempool(conns.mempool, MempoolConfig(), plane=plane)
    gen = loadgen.LoadGen(loadgen.broadcast_tx_sync(run.mempool), corpus,
                          workers=workers)
    idx = np.arange(n_vals, dtype=np.int32)
    try:
        for lo in range(0, len(corpus), round_size):
            burst = None
            if run.blocks:                  # prevotes for the last block
                bid = state.last_block_id
                tmpl = canonical.batch_sign_bytes(
                    CHAIN_ID, np.array([canonical.TYPE_PREVOTE]),
                    np.array([state.last_block_height]), np.array([0]),
                    np.frombuffer(bid.hash, np.uint8)[None],
                    np.frombuffer(bid.parts.hash, np.uint8)[None],
                    np.array([bid.parts.total]))
                sigs = backend.sign_grouped_templated(
                    seeds, idx, np.zeros(n_vals, np.int32), tmpl)
                args = (vals.set_key(), vals.pubs_matrix(), idx,
                        np.repeat(tmpl, n_vals, 0), sigs)
                burst = threading.Thread(
                    target=lambda a=args: run.votes.append(
                        plane.verify_grouped(*a, producer="consensus",
                                             klass=CLASS_CONSENSUS)))
            if burst is not None:
                burst.start()
            results, wall = gen.submit_each(corpus[lo:lo + round_size])
            run.results += results
            if burst is not None:
                burst.join()
            t1 = time.perf_counter()
            block, bid = make_block(
                CHAIN_ID, state.last_block_height + 1,
                run.mempool.reap(MAX_BLOCK_TXS), state.last_block_id,
                n_vals, vals.hash(), state.app_hash)
            execution.apply_window(state, conns.consensus,
                                   [(block, bid.parts)], run.mempool)
            run.blocks.append(block)
            run.ingress_s += wall
            run.apply_s += time.perf_counter() - t1
    finally:
        plane.stop()
    return run
