"""Block validation and execution against the ABCI app.

Copy of `tendermint_tpu/state/execution.py` (reference
`state/execution.go`): `validate_block` (`:173-202`), `exec_block_on_app`
(`:43-115`), `ApplyBlock` (`:210-245`) and its window form,
`CommitStateUpdateMempool` (`:248-271`) and `ExecCommitBlock`
(`:291-308`).  `apply_block` fires per-tx events into the consensus
state's event cache and indexes txs when given an indexer; fail points
are not ported.
"""

from __future__ import annotations

from contextlib import nullcontext
from dataclasses import dataclass

from tendermint_tpu_torch.abci.types import RequestBeginBlock
from tendermint_tpu_torch.state.state import ABCIResponses, State
from tendermint_tpu_torch.types import BlockID
from tendermint_tpu_torch.types.events import event_tx
from tendermint_tpu_torch.types.tx import Tx


class MockMempool:
    """No-op mempool for replay paths (reference `types/services.go:31-42`)."""

    def lock(self):
        pass

    def unlock(self):
        pass

    def update(self, height: int, txs: list[bytes]):
        pass


@dataclass
class TxEvent:
    """Payload of a per-tx event (fired during exec, flushed post-commit)."""
    height: int
    tx: bytes
    result: object
    index: int


def validate_block(state: State, block, backend=None) -> None:
    """Full contextual validation (reference `state/execution.go:173-202`).

    With `backend=None` the +2/3 LastCommit signature check is skipped —
    for the fast-sync window loop, which verifies every commit in one
    batched device call BEFORE applying (re-verifying here would double
    the dominant cost; the reference does pay it twice,
    `blockchain/reactor.go:230` then `state/execution.go:177-202`).
    """
    block.validate_basic()
    h = block.header
    if h.chain_id != state.chain_id:
        raise ValueError(f"wrong chain id {h.chain_id!r}")
    if h.height != state.last_block_height + 1:
        raise ValueError(f"wrong height {h.height}, "
                         f"expected {state.last_block_height + 1}")
    if h.last_block_id.key() != state.last_block_id.key():
        raise ValueError("wrong last_block_id")
    if h.app_hash != state.app_hash:
        raise ValueError(f"wrong app_hash {h.app_hash.hex()} "
                         f"!= {state.app_hash.hex()}")
    if h.validators_hash != state.validators.hash():
        raise ValueError("wrong validators_hash")
    if h.height > 1:
        if len(block.last_commit.precommits) != state.last_validators.size():
            raise ValueError("last_commit size != last validator set")
        if backend is not None:
            state.last_validators.verify_commit(
                state.chain_id, h.last_block_id, h.height - 1,
                block.last_commit, backend)


def exec_block_on_app(proxy_consensus, block,
                      event_cache=None) -> ABCIResponses:
    """BeginBlock / DeliverTx xN / EndBlock (reference
    `state/execution.go:43-115`); returns ABCIResponses.  With an
    `event_cache`, each tx's result is fired under its `Tx:<hash>` key."""
    proxy_consensus.begin_block(
        RequestBeginBlock(hash=block.hash(), header=block.header))
    results = [proxy_consensus.deliver_tx(tx) for tx in block.txs]
    if event_cache is not None:
        for i, (tx, res) in enumerate(zip(block.txs, results)):
            event_cache.fire(event_tx(Tx(tx).hash),
                             TxEvent(block.height, tx, res, i))
    end = proxy_consensus.end_block(block.height)
    diffs = [(v.pub_key, v.power) for v in end.diffs]
    return ABCIResponses(height=block.height, deliver_txs=results,
                         end_block_diffs=diffs)


def apply_block(state: State, proxy_consensus, block, part_set_header,
                mempool, backend=None, event_cache=None,
                tx_indexer=None) -> State:
    """Validate, execute and commit one block, then persist the state
    (reference `state/execution.go:210-245`); mutates `state` in place and
    returns it.  With a `backend` the block's LastCommit signatures are
    verified through it; with None they are not (commits verified
    beforehand, as fast-sync does).  Tx events go to `event_cache` and
    results to `tx_indexer` when given."""
    validate_block(state, block, backend)
    resp = exec_block_on_app(proxy_consensus, block, event_cache)
    if tx_indexer is not None:
        tx_indexer.index_block(block, resp)
    state.save_abci_responses(resp)
    block_id = BlockID(hash=block.hash(), parts=part_set_header)
    state.set_block_and_validators(block.header, block_id,
                                   resp.end_block_diffs)
    commit_state_update_mempool(state, proxy_consensus, block, mempool)
    state.save()
    return state


def apply_window(state: State, proxy_consensus, items, mempool,
                 save_every: int = 1, before_block=None,
                 stop_when=None) -> int:
    """Apply a verified fast-sync WINDOW of blocks (`items` =
    [(block, part_set_header)]) — `ApplyBlock` unrolled across the window
    so the per-block overheads amortize: the consensus conn's lock is held
    ONCE for the window (`AppConn.batched`), and with `save_every=0` state
    persistence collapses to one `save()` at the window end (ephemeral
    replays only: a crash mid-window leaves the store more than one block
    ahead of the state, which the handshake cannot recover).  Commits were
    verified by the caller, so validation skips the LastCommit signatures.
    Hooks: `before_block(block, psh)` runs before validation (the
    pipeline saves the block to the block store there, store before
    state); `stop_when()`, checked after each block's commit, ends the
    window early.
    Returns the number of blocks applied.
    """
    batched = getattr(proxy_consensus, "batched", None)
    ctx = nullcontext(proxy_consensus) if batched is None else batched()
    applied = 0
    with ctx as app:
        for block, psh in items:
            if before_block is not None:
                before_block(block, psh)
            validate_block(state, block)
            resp = exec_block_on_app(app, block)
            state.save_abci_responses(resp)
            block_id = BlockID(hash=block.hash(), parts=psh)
            state.set_block_and_validators(block.header, block_id,
                                           resp.end_block_diffs)
            commit_state_update_mempool(state, app, block, mempool)
            applied += 1
            if save_every and applied % save_every == 0:
                state.save()
            if stop_when is not None and stop_when():
                break
    if applied and not (save_every and applied % save_every == 0):
        state.save()
    return applied


def commit_state_update_mempool(state: State, proxy_consensus, block,
                                mempool) -> None:
    """App Commit with the mempool locked so no CheckTx runs against a
    half-committed app (reference `state/execution.go:248-271`)."""
    mempool.lock()
    try:
        res = proxy_consensus.commit()
        if not res.is_ok:
            raise RuntimeError(f"app Commit failed: {res.log}")
        state.app_hash = res.data
        mempool.update(block.height, block.txs)
    finally:
        mempool.unlock()


def exec_commit_block(proxy_consensus, block) -> bytes:
    """Execute and commit a block without touching the state — the
    handshake's replay of blocks the app is missing (reference
    `state/execution.go:291-308`).  Returns the app hash."""
    exec_block_on_app(proxy_consensus, block)
    res = proxy_consensus.commit()
    if not res.is_ok:
        raise RuntimeError(f"app Commit failed: {res.log}")
    return res.data
