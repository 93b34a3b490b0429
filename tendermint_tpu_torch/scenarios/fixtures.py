"""Deterministic chain fixtures: N priv-validators producing a valid
chain of blocks with real commits.

Copy of `tendermint_tpu/scenarios/fixtures.py` (the analog of the
reference's validatorStub fixtures, `consensus/common_test.go:48-106`).
Each block embeds the signed commit of the block before it, so a served
chain verifies block h with block h+1's LastCommit as the fast-sync
reactor does.  Header h+1 commits to commit h's hash, so a chain is built
height by height: `make_commit` signs one height's precommits with
`priv.sign_vote` (the golden signer, ~7 ms a signature in pure Python)
or, given a `backend`, in one `sign_grouped_templated` call of `n_vals`
lanes (kernel K3 on `CudaBackend`); both give the same bytes.  `txs`
makes a block's txs from its height where the JAX fixture's
`b"tx-<h>-<i>"` pattern is not wanted.
"""

from __future__ import annotations

import numpy as np

from tendermint_tpu_torch.crypto import pure_ed25519 as ref
from tendermint_tpu_torch.types import (Block, BlockID, Commit, EMPTY_COMMIT,
                                        GenesisDoc, GenesisValidator, PrivKey,
                                        PrivValidator, TYPE_PRECOMMIT,
                                        Validator, ValidatorSet, Vote,
                                        VoteSet, ZERO_BLOCK_ID)
from tendermint_tpu_torch.types.part_set import PART_SIZE as _PROD_PART_SIZE

__all__ = ["PART_SIZE", "make_validators", "make_genesis", "sign_vote",
           "make_commit", "kvstore_app_hashes", "build_chain"]

# the production part size: fast-sync re-chunks blocks with the default,
# so fixture commits must sign the same parts header it will recompute
PART_SIZE = _PROD_PART_SIZE

SPOT_CHECKS = 16      # backend-signed lanes checked by the golden verifier


def make_validators(n: int, power: int = 10, seed: int = 0):
    """Deterministic keys so fixtures are reproducible."""
    privs = [PrivValidator(PrivKey(bytes([seed + 1, i + 1]) + b"\x00" * 30))
             for i in range(n)]
    vs = ValidatorSet([Validator(p.pub_key, power) for p in privs])
    privs.sort(key=lambda p: p.address)
    return privs, vs


def make_genesis(chain_id: str, privs, power: int = 10) -> GenesisDoc:
    return GenesisDoc(
        chain_id=chain_id,
        validators=[GenesisValidator(p.pub_key.bytes_, power)
                    for p in privs],
        genesis_time_ns=1_000_000_000)


def sign_vote(priv: PrivValidator, vs: ValidatorSet, chain_id: str,
              height: int, round_: int, type_: int, block_id) -> Vote:
    idx = vs.index_of(priv.address)
    v = Vote(validator_address=priv.address, validator_index=idx,
             height=height, round=round_, type=type_, block_id=block_id)
    return Vote(**{**v.__dict__,
                   "signature": priv.sign_vote(chain_id, v)})


def make_commit(privs, vs: ValidatorSet, chain_id: str, height: int,
                block_id, round_: int = 0, backend=None) -> Commit:
    """The +2/3 commit of every priv's precommit for `block_id`.  With a
    `backend` the precommits are signed in one `sign_grouped_templated`
    call on their shared sign bytes and added unverified (`build_chain`
    spot-checks them)."""
    if backend is None:
        votes = [sign_vote(p, vs, chain_id, height, round_, TYPE_PRECOMMIT,
                           block_id) for p in privs]
        verify = True
    else:
        votes = [Vote(validator_address=p.address,
                      validator_index=vs.index_of(p.address), height=height,
                      round=round_, type=TYPE_PRECOMMIT, block_id=block_id)
                 for p in privs]
        template = np.frombuffer(votes[0].sign_bytes(chain_id),
                                 np.uint8).reshape(1, -1)
        lanes = np.arange(len(privs), dtype=np.int32)
        sigs = backend.sign_grouped_templated(
            [p.priv_key.seed for p in privs], lanes, np.zeros_like(lanes),
            template)
        votes = [Vote(**{**v.__dict__, "signature": s.tobytes()})
                 for v, s in zip(votes, sigs)]
        verify = False
    vset = VoteSet(chain_id, height, round_, TYPE_PRECOMMIT, vs)
    for v in votes:
        vset.add_vote(v, verify=verify)
    return vset.make_commit()


def _default_txs(height: int, txs_per_block: int) -> list[bytes]:
    return [b"tx-%d-%d" % (height, i) for i in range(txs_per_block)]


def kvstore_app_hashes(n: int, txs_per_block: int = 2,
                       txs=None) -> list[bytes]:
    """App hashes for a kvstore app fed build_chain's deterministic txs
    (`txs(height)` when given): entry i is the hash going INTO block
    i+1."""
    from tendermint_tpu_torch.abci.app import create_app
    app = create_app("kvstore")
    hashes = [b""]
    for h in range(1, n + 1):
        for tx in (txs(h) if txs is not None
                   else _default_txs(h, txs_per_block)):
            app.deliver_tx(tx)
        hashes.append(app.commit().data)
    return hashes[:-1]


def build_chain(privs, vs: ValidatorSet, chain_id: str, n_blocks: int,
                txs_per_block: int = 2, app_hashes: list[bytes] | None = None,
                part_size: int = PART_SIZE, backend=None, txs=None):
    """Returns [(block, part_set, seen_commit)] for heights 1..n.

    app_hashes[i] is the app hash *going into* block i+1 (i.e. after block
    i executed); defaults to empty (nilapp semantics).  With a `backend`
    each height's commit is signed in one call on it (`make_commit`) and
    SPOT_CHECKS votes across the chain are checked by the golden
    verifier.
    """
    out = []
    last_commit = EMPTY_COMMIT
    last_block_id = ZERO_BLOCK_ID
    vals_hash = vs.hash()
    for h in range(1, n_blocks + 1):
        app_hash = (app_hashes[h - 1] if app_hashes else b"")
        block = Block.make(chain_id=chain_id, height=h,
                           time_ns=1_000_000_000 + h,
                           txs=(txs(h) if txs is not None
                                else _default_txs(h, txs_per_block)),
                           last_commit=last_commit,
                           last_block_id=last_block_id,
                           validators_hash=vals_hash, app_hash=app_hash)
        ps = block.make_part_set(part_size)
        block_id = BlockID(block.hash(), ps.header)
        seen = make_commit(privs, vs, chain_id, h, block_id,
                           backend=backend)
        out.append((block, ps, seen))
        last_commit = seen
        last_block_id = block_id
    if backend is not None and out:
        rng = np.random.default_rng(3)
        for i in rng.integers(0, len(out) * len(privs), SPOT_CHECKS):
            h, v = divmod(int(i), len(privs))
            vote = out[h][2].precommits[v]
            if not ref.verify(vs.validators[v].pub_key.bytes_,
                              vote.sign_bytes(chain_id), vote.signature):
                raise RuntimeError(f"fixture vote {v} at height {h + 1} "
                                   f"does not verify")
    return out
