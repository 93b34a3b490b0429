"""The fast-sync replay slice, end to end: an 8-block x 4-validator chain
replayed through the port (`CudaBackend(device="cpu")`, so every kernel
runs its plain PyTorch version) and through the JAX package's own
`verify_commits_batched` + `apply_window` on its python backend.  Both
must reach the same height, app hash and per-window tallies, and a
tampered signature must raise the same error at the same height and lane.
"""

import os

import numpy as np
import pytest
import torch

from tendermint_tpu.crypto import backend as jcb
from tendermint_tpu.proxy import ClientCreator as JClientCreator
from tendermint_tpu.state import execution as jexec
from tendermint_tpu.state.state import get_state as jget_state
from tendermint_tpu.types import (Block as JBlock, BlockID as JBlockID,
                                  GenesisDoc as JGenesisDoc)
from tendermint_tpu.types.block import CompactCommit as JCompactCommit
from tendermint_tpu.types.part_set import (
    PartSetHeader as JPartSetHeader, from_data_batched as jfrom_data)
from tendermint_tpu.types.validator import (
    CommitSignatureError as JCommitSignatureError,
    verify_commits_batched as jverify_commits, window_commit_lanes as jlanes)
from tendermint_tpu.utils.db import MemDB as JMemDB
from tendermint_tpu_torch.blockchain import replay as rp
from tendermint_tpu_torch.crypto.backend import CudaBackend, PythonBackend
from tendermint_tpu_torch.proxy import ClientCreator
from tendermint_tpu_torch.state.state import get_state
from tendermint_tpu_torch.types.block import CompactCommit
from tendermint_tpu_torch.types.validator import (CommitSignatureError,
                                                  verify_commits_batched)
from tendermint_tpu_torch.utils.db import MemDB

N_VALS, N_BLOCKS, WINDOW = 4, 8, 3
TAMPER_HEIGHT, TAMPER_LANE = 5, 2


@pytest.fixture(autouse=True, scope="module")
def _share_cores():
    """xdist runs several files at once: a worker's share of the cores for
    torch keeps the plain versions' wide tensor ops from oversubscribing
    them (several torch pools on the same cores run ~20x slower)."""
    n = torch.get_num_threads()
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _jax_python_backend():
    old = jcb._current
    jcb.set_backend("python")
    yield
    jcb._current = old


@pytest.fixture(scope="module")
def port():
    be = CudaBackend(device="cpu")
    chain = rp.build_chain(N_VALS, N_BLOCKS, be, payload=512)
    return be, chain


def _to_jax(chain):
    """The same chain as the JAX package's objects (the codecs agree, so
    blocks cross as their wire bytes)."""
    blocks = [JBlock.decode_bytes(b.encode()) for b in chain.blocks]
    commits = [JCompactCommit(
        block_id=JBlockID(c.block_id.hash, JPartSetHeader(
            c.block_id.parts.total, c.block_id.parts.hash)),
        height_=c.height_, round_=c.round_, sigs=c.sigs, present=c.present)
        for c in chain.commits]
    return JGenesisDoc.from_json(chain.genesis.to_json()), blocks, commits


def _jax_items(blocks, commits):
    parts = jfrom_data([b.encode() for b in blocks])
    return parts, [(JBlockID(b.hash(), ps.header), b.height, c)
                   for b, ps, c in zip(blocks, parts, commits)]


def _tamper(commit, cls):
    sigs = commit.sigs.copy()
    sigs[TAMPER_LANE, 3] ^= 0x40
    return cls(block_id=commit.block_id, height_=commit.height_,
               round_=commit.round_, sigs=sigs, present=commit.present)


def test_replay_matches_reference(port):
    be, chain = port
    state = get_state(MemDB(), chain.genesis)
    res = rp.replay(state, ClientCreator("kvstore").new_app_conns().consensus,
                    chain.blocks, chain.commits, be, window=WINDOW)
    assert res.height == N_BLOCKS and res.sigs == N_BLOCKS * N_VALS

    jgen, jblocks, jcommits = _to_jax(chain)
    jstate = jget_state(JMemDB(), jgen)
    jconns = JClientCreator("kvstore").new_app_conns()
    tallies = []
    for lo in range(0, N_BLOCKS, WINDOW):
        parts, items = _jax_items(jblocks[lo:lo + WINDOW],
                                  jcommits[lo:lo + WINDOW])
        tallies.append(jlanes(jstate.validators, jgen.chain_id,
                              items)[5].tolist())
        jverify_commits(jstate.validators, jgen.chain_id, items)
        jexec.apply_window(jstate, None, jconns.consensus,
                           [(b, ps.header) for b, ps in
                            zip(jblocks[lo:lo + WINDOW], parts)],
                           jexec.MockMempool(), save_every=0)
    assert (res.height, res.app_hash) == (jstate.last_block_height,
                                          jstate.app_hash)
    assert [w.tallied for w in res.windows] == tallies
    assert state.last_block_id.key() == jstate.last_block_id.key()

    # the port's golden backend replays the same chain to the same state
    state = get_state(MemDB(), chain.genesis)
    gold = rp.replay(state, ClientCreator("kvstore").new_app_conns().consensus,
                     chain.blocks, chain.commits, PythonBackend(),
                     window=WINDOW)
    assert (gold.height, gold.app_hash) == (res.height, res.app_hash)
    assert [w.tallied for w in gold.windows] == tallies


def test_tampered_lane_same_error(port):
    be, chain = port
    j = TAMPER_HEIGHT - 1
    lo = j - j % WINDOW
    commits = list(chain.commits[lo:lo + WINDOW])
    commits[j - lo] = _tamper(commits[j - lo], CompactCommit)
    state = get_state(MemDB(), chain.genesis)
    _, _, items = rp.prepare_window(chain.blocks[lo:lo + WINDOW], commits,
                                    state.validators.hash(), be)
    with pytest.raises(CommitSignatureError) as got:
        verify_commits_batched(state.validators, state.chain_id, items, be)

    jgen, jblocks, jcommits = _to_jax(chain)
    jcommits[j] = _tamper(jcommits[j], JCompactCommit)
    jstate = jget_state(JMemDB(), jgen)
    _, jitems = _jax_items(jblocks[lo:lo + WINDOW], jcommits[lo:lo + WINDOW])
    with pytest.raises(JCommitSignatureError) as want:
        jverify_commits(jstate.validators, jgen.chain_id, jitems)
    assert (got.value.height, got.value.lane) == \
        (want.value.height, want.value.lane) == (TAMPER_HEIGHT, TAMPER_LANE)
    assert str(got.value) == str(want.value)

    # the whole replay stops at the tampered window, before applying it
    bad = list(chain.commits)
    bad[j] = commits[j - lo]
    state = get_state(MemDB(), chain.genesis)
    with pytest.raises(CommitSignatureError):
        rp.replay(state, ClientCreator("kvstore").new_app_conns().consensus,
                  chain.blocks, bad, be, window=WINDOW)
    assert state.last_block_height == lo
    np.testing.assert_array_equal(chain.commits[j].sigs[TAMPER_LANE, :3],
                                  bad[j].sigs[TAMPER_LANE, :3])
