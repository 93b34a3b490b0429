"""Test helper: the same chain as the JAX package's objects and the
port's.  The two codecs agree, so blocks, commits and validator sets
cross as their wire bytes."""

from __future__ import annotations

import os

import numpy as np
import torch

from tendermint_tpu.types import (Block as JBlock, BlockID as JBlockID,
                                  GenesisDoc as JGenesisDoc)
from tendermint_tpu.types.block import (Commit as JCommit,
                                        CompactCommit as JCompactCommit)
from tendermint_tpu.types.part_set import PartSetHeader as JPartSetHeader
from tendermint_tpu.types.validator import ValidatorSet as JValidatorSet
from tendermint_tpu_torch.crypto import pure_ed25519 as ref
from tendermint_tpu_torch.types import Block, Commit, GenesisDoc
from tendermint_tpu_torch.types.codec import Reader
from tendermint_tpu_torch.types.validator import ValidatorSet


class GoldenSigner:
    """`sign_grouped_templated` on the golden RFC 8032 signer, for
    `blockchain.replay.build_chain` where the kernels are not the point."""

    def sign_grouped_templated(self, seeds, val_idx, tmpl_idx, templates):
        return np.frombuffer(b"".join(
            ref.sign(seeds[v], templates[t].tobytes())
            for v, t in zip(val_idx, tmpl_idx)), np.uint8).reshape(-1, 64)


def share_cores():
    """Give torch this xdist worker's share of the cores (several torch
    pools on the same cores run many times slower); returns the old
    thread count."""
    n = torch.get_num_threads()
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
    return n


# -- JAX -> port ------------------------------------------------------------

def port_block(jb) -> Block:
    return Block.decode_bytes(jb.encode())


def port_commit(jc) -> Commit:
    return Commit.decode(Reader(jc.encode()))


def port_vals(jvs) -> ValidatorSet:
    return ValidatorSet.decode(Reader(jvs.encode()))


def port_chain(jchain) -> list[tuple]:
    """chainutil's [(block, part_set, seen_commit)] as the port's."""
    out = []
    for jb, jps, jseen in jchain:
        b = port_block(jb)
        ps = b.make_part_set()
        assert ps.header.encode() == jps.header.encode()
        out.append((b, ps, port_commit(jseen)))
    return out


# -- port -> JAX ------------------------------------------------------------

def jax_block(b) -> JBlock:
    return JBlock.decode_bytes(b.encode())


def jax_block_id(bid) -> JBlockID:
    return JBlockID(bid.hash, JPartSetHeader(bid.parts.total, bid.parts.hash))


def jax_commit(c):
    """A port Commit or CompactCommit as the JAX package's."""
    if isinstance(c, Commit):
        return JCommit.decode(Reader(c.encode()))
    return JCompactCommit(block_id=jax_block_id(c.block_id),
                          height_=c.height_, round_=c.round_, sigs=c.sigs,
                          present=c.present)


def jax_vals(vs) -> JValidatorSet:
    from tendermint_tpu.types.codec import Reader as JReader
    return JValidatorSet.decode(JReader(vs.encode()))


def jax_genesis(gen: GenesisDoc) -> JGenesisDoc:
    return JGenesisDoc.from_json(gen.to_json())
