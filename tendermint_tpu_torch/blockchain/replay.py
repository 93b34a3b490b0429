"""Fast-sync window replay and its chain fixture.

The replay loop is the window loop of the reference's fast-sync reactor
(`tendermint_tpu/blockchain/reactor.py` `_prepare_window` + `_sync_step`)
and of its benchmark (`bench.py` `_replay_chain`), without networking and
without the thread pipeline.  Each window of blocks goes through three
steps:

1. prepare — re-hash every block's part set (`from_data_batched`) and pair
   each block's ID with the +2/3 commit that proves it;
2. verify — every commit signature of the window in ONE grouped backend
   call (`verify_commits_batched`, kernel K1 on the "cuda" backend);
3. apply — execute the window through the ABCI app (`apply_window`).

`build_chain` makes a deterministic chain in the shape of the reference's
benchmark fixture (`bench.py` `_fixture_build_base`): hash-linked blocks
with one ~12 KB kvstore tx each, and seen commits signed in bulk by the
backend (kernel K3 on the "cuda" backend).
"""

from __future__ import annotations

import gc
import time
from dataclasses import dataclass, field

import numpy as np

from tendermint_tpu_torch.abci.app import create_app
from tendermint_tpu_torch.crypto import pure_ed25519 as ref
from tendermint_tpu_torch.state import execution
from tendermint_tpu_torch.types import (Block, BlockID, Commit,
                                        CompactCommit, EMPTY_COMMIT,
                                        GenesisDoc, GenesisValidator,
                                        ZERO_BLOCK_ID, canonical)
from tendermint_tpu_torch.types.part_set import from_data_batched
from tendermint_tpu_torch.types.validator import verify_commits_batched

DEFAULT_WINDOW = 625          # BASELINE config 3: 62,500 lanes at V = 100
SIGN_CHUNK_BLOCKS = 655       # 65,500 signing lanes per call at V = 100


@dataclass
class Chain:
    """A replayable chain: genesis, blocks, and each block's seen commit
    (the +2/3 precommits for it, in array form)."""
    genesis: GenesisDoc
    seeds: list[bytes]          # in validator-set order
    blocks: list[Block]
    commits: list[CompactCommit]


@dataclass
class WindowStats:
    first_height: int
    blocks: int
    lanes: int
    tallied: list[int]         # per block: power voting for it
    prepare_s: float
    verify_s: float
    apply_s: float


@dataclass
class ReplayResult:
    height: int
    app_hash: bytes
    windows: list[WindowStats] = field(default_factory=list)

    @property
    def sigs(self) -> int:
        return sum(w.lanes for w in self.windows)


def payload_txs(height: int, payload: int) -> list[bytes]:
    """One tx per block carrying `payload` bytes on a reused key, so the
    kvstore does the same work at every height (`bench.py` txs_for)."""
    return [b"p=%d:" % height + b"\xaa" * payload]


def make_block(chain_id: str, height: int, txs: list[bytes],
               last_block_id: BlockID, n_vals: int, vals_hash: bytes,
               app_hash: bytes) -> tuple[Block, BlockID]:
    """The block at `height` carrying `txs`, hash-linked to
    `last_block_id`, with an unsigned embedded last commit of `n_vals`
    slots (callers verify seen commits, or none) and the fixture's clock
    (1 s + height ns).  Returns (block, its BlockID with the part-set
    header)."""
    last_commit = (EMPTY_COMMIT if height == 1 else
                   Commit(block_id=last_block_id,
                          precommits=[None] * n_vals))
    block = Block.make(chain_id=chain_id, height=height,
                       time_ns=1_000_000_000 + height, txs=txs,
                       last_commit=last_commit,
                       last_block_id=last_block_id,
                       validators_hash=vals_hash, app_hash=app_hash)
    return block, BlockID(block.hash(), block.make_part_set().header)


def build_chain(n_vals: int, n_blocks: int, backend, payload: int = 12 * 1024,
                chain_id: str = "bench-chain", power: int = 10) -> Chain:
    """Deterministic chain of `n_blocks` blocks signed by `n_vals`
    validators (seed bytes [1, i+1] + 30 zeros, as the reference's
    `make_validators`).  Pass 1 builds hash-linked blocks whose embedded
    last commits are unsigned (the replay verifies each block's SEEN
    commit, as the reference's sync loop verifies a +2/3 commit per
    block); pass 2 signs all n_blocks x n_vals precommits with
    `backend.sign_grouped_templated` and spot-checks 16 lanes against the
    golden verifier."""
    seeds = [bytes([1, i + 1]) + b"\0" * 30 for i in range(n_vals)]
    pubs = [ref.pubkey_from_seed(s) for s in seeds]
    genesis = GenesisDoc(
        chain_id=chain_id,
        validators=[GenesisValidator(p, power) for p in pubs],
        genesis_time_ns=1_000_000_000)
    vs = genesis.validator_set()
    by_pub = dict(zip(pubs, seeds))
    seeds = [by_pub[v.pub_key.bytes_] for v in vs.validators]

    app = create_app("kvstore")
    app_hashes = [b""]
    for h in range(1, n_blocks):
        for tx in payload_txs(h, payload):
            app.deliver_tx(tx)
        app_hashes.append(app.commit().data)

    gc.disable()       # many long-lived objects; re-enabled below
    try:
        vals_hash = vs.hash()
        blocks, bids = [], []
        last_block_id = ZERO_BLOCK_ID
        for h in range(1, n_blocks + 1):
            block, bid = make_block(chain_id, h, payload_txs(h, payload),
                                    last_block_id, n_vals, vals_hash,
                                    app_hashes[h - 1])
            blocks.append(block)
            bids.append(bid)
            last_block_id = bid
    finally:
        gc.enable()

    bh = np.frombuffer(b"".join(b.hash for b in bids),
                       np.uint8).reshape(n_blocks, 32)
    ph = np.frombuffer(b"".join(b.parts.hash for b in bids),
                       np.uint8).reshape(n_blocks, 32)
    pt = np.array([b.parts.total for b in bids], np.int64)
    templates = canonical.batch_sign_bytes(
        chain_id, np.full(n_blocks, canonical.TYPE_PRECOMMIT, np.int64),
        np.arange(1, n_blocks + 1, dtype=np.int64),
        np.zeros(n_blocks, np.int64), bh, ph, pt)
    sigs = np.zeros((n_blocks * n_vals, 64), np.uint8)
    val_idx = np.tile(np.arange(n_vals, dtype=np.int32), SIGN_CHUNK_BLOCKS)
    for off in range(0, n_blocks, SIGN_CHUNK_BLOCKS):
        nb = min(SIGN_CHUNK_BLOCKS, n_blocks - off)
        sigs[off * n_vals:(off + nb) * n_vals] = \
            backend.sign_grouped_templated(
                seeds, val_idx[:nb * n_vals],
                np.repeat(np.arange(nb, dtype=np.int32), n_vals),
                templates[off:off + nb])
    pubs_vs = [v.pub_key.bytes_ for v in vs.validators]
    rng = np.random.default_rng(3)
    for i in rng.integers(0, len(sigs), 16):
        v, h = int(i) % n_vals, int(i) // n_vals
        if not ref.verify(pubs_vs[v], templates[h].tobytes(),
                          sigs[int(i)].tobytes()):
            raise RuntimeError(f"fixture lane {int(i)} does not verify")
    present = np.ones(n_vals, dtype=bool)
    commits = [CompactCommit(block_id=bids[h], height_=h + 1, round_=0,
                             sigs=sigs[h * n_vals:(h + 1) * n_vals],
                             present=present)
               for h in range(n_blocks)]
    return Chain(genesis=genesis, seeds=seeds, blocks=blocks,
                 commits=commits)


def prepare_window(blocks: list[Block], commits: list, vals_hash: bytes,
                   backend) -> tuple:
    """Cut the window at the first block whose header names another
    validator set (later blocks verify against the updated state), re-hash
    the part sets, and pair each block ID with its commit.  Returns
    (blocks, part_sets, items); items are (block_id, height, commit)."""
    cut = len(blocks)
    for i, b in enumerate(blocks):
        if b.header.validators_hash != vals_hash:
            cut = i
            break
    blocks = blocks[:cut]
    parts = from_data_batched([b.encode() for b in blocks], backend=backend)
    items = [(BlockID(b.hash(), ps.header), b.height, c)
             for b, ps, c in zip(blocks, parts, commits)]
    return blocks, parts, items


def replay(state, proxy_consensus, blocks: list[Block], commits: list,
           backend, window: int = DEFAULT_WINDOW) -> ReplayResult:
    """Replay `blocks` (with their seen `commits`) onto `state` window by
    window: prepare, verify every commit of the window in one backend call,
    apply.  Raises the canonical commit errors (`CommitSignatureError`,
    `CommitPowerError`, `CommitFormatError`) naming the failing height."""
    result = ReplayResult(height=state.last_block_height,
                          app_hash=state.app_hash)
    i = 0
    while i < len(blocks):
        t0 = time.perf_counter()
        win, parts, items = prepare_window(
            blocks[i:i + window], commits[i:i + window],
            state.validators.hash(), backend)
        if not win:
            raise ValueError(f"block {blocks[i].height}: validators_hash "
                             f"does not match the state's validator set")
        t1 = time.perf_counter()
        lanes, tallied = verify_commits_batched(
            state.validators, state.chain_id, items, backend)
        t2 = time.perf_counter()
        execution.apply_window(state, proxy_consensus,
                               [(b, ps.header) for b, ps in zip(win, parts)],
                               execution.MockMempool(), save_every=0)
        t3 = time.perf_counter()
        result.windows.append(WindowStats(
            win[0].height, len(win), lanes, [int(x) for x in tallied],
            t1 - t0, t2 - t1, t3 - t2))
        i += len(win)
    result.height = state.last_block_height
    result.app_hash = state.app_hash
    return result
