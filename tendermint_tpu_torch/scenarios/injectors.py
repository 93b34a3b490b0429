"""Composable fault injectors.

Each injector derives its decisions from a ctx-provided RNG and records
them as plan events (hashed into the determinism contract) before any
runtime effect; what actually lands is recorded as notes.  Injectors
never reach for wall-clock randomness — the whole point is that the
same seed replays the same fault schedule.

Copy of `tendermint_tpu/scenarios/injectors.py`.  Votes and evidence are
signed on the host (`PrivKey.sign`, the native rung), as in the JAX
package.
"""

from __future__ import annotations

import os
import struct

from tendermint_tpu_torch.blockchain import messages as BM
from tendermint_tpu_torch.blockchain.reactor import BLOCKCHAIN_CHANNEL
from tendermint_tpu_torch.consensus import messages as M
from tendermint_tpu_torch.consensus.wal import REC_MESSAGE
from tendermint_tpu_torch.p2p.fuzz import FuzzedConnection
from tendermint_tpu_torch.types import (TYPE_PREVOTE, Vote, ZERO_BLOCK_ID)
from tendermint_tpu_torch.types.block import Block
from tendermint_tpu_torch.types.vote import DuplicateVoteEvidence


def plan_heights(ctx, name: str, lo: int, hi: int, k: int) -> list[int]:
    """Pick k distinct target heights in [lo, hi] from the scenario seed
    and log them as the injection schedule."""
    rng = ctx.rng(name)
    span = list(range(lo, hi + 1))
    rng.shuffle(span)
    heights = sorted(span[:k])
    ctx.plan(name, heights=heights)
    return heights


# -- byzantine vote streams -------------------------------------------------

def equivocate(ctx, node, priv, chain_id: str, heights: list[int],
               broadcast=None) -> None:
    """Make `node` double-sign: for every prevote at a scheduled height
    it also signs a conflicting nil prevote with the raw key (bypassing
    the PrivValidator HRS guard, like the reference's
    ByzantinePrivValidator) and broadcasts it.  `broadcast` defaults to
    the node's own broadcast_cb (wire nets)."""
    targets = set(heights)
    orig_sign_add = node.cs._sign_add_vote
    send = broadcast or (lambda msg: node.cs.broadcast_cb(msg))

    def equivocating_sign_add(type_, block_id):
        orig_sign_add(type_, block_id)
        if (type_ != TYPE_PREVOTE or block_id.is_zero()
                or node.cs.height not in targets):
            return
        idx = node.cs.validators.index_of(priv.address)
        v = Vote(validator_address=priv.address, validator_index=idx,
                 height=node.cs.height, round=node.cs.round, type=type_,
                 block_id=ZERO_BLOCK_ID)
        sig = priv.priv_key.sign(v.sign_bytes(chain_id))
        v = Vote(**{**v.__dict__, "signature": sig})
        ctx.note("equivocation.sent", height=v.height, round=v.round)
        send(M.VoteMessage(v))

    node.cs._sign_add_vote = equivocating_sign_add


def fabricate_evidence(ctx, privs, vs, chain_id: str, n_real: int,
                       n_bogus: int) -> tuple[list, list]:
    """Evidence-flood ammunition: `n_real` valid equivocation proofs by
    in-set validators, and `n_bogus` invalid ones (stranger validators,
    agreeing votes, torn signatures) that a sound pool must refuse.
    Returns (real, bogus)."""
    from tendermint_tpu_torch.types import BlockID, PrivKey, PrivValidator

    rng = ctx.rng("evidence")

    def conflicting_pair(priv, height, in_set: bool):
        idx = vs.index_of(priv.address) if in_set else 0
        bid = BlockID(bytes([rng.randrange(1, 256)]) * 32)

        def signed(block_id):
            v = Vote(validator_address=priv.address, validator_index=idx,
                     height=height, round=0, type=TYPE_PREVOTE,
                     block_id=block_id)
            sig = priv.priv_key.sign(v.sign_bytes(chain_id))
            return Vote(**{**v.__dict__, "signature": sig})
        return signed(bid), signed(ZERO_BLOCK_ID)

    real = []
    for i in range(n_real):
        priv = privs[rng.randrange(len(privs))]
        a, b = conflicting_pair(priv, height=1 + i, in_set=True)
        real.append(DuplicateVoteEvidence(a, b))

    bogus = []
    for i in range(n_bogus):
        kind = rng.randrange(3)
        if kind == 0:                       # stranger: not in the set
            stranger = PrivValidator(
                PrivKey(bytes([200 + i % 50, rng.randrange(256)])
                        + b"\x00" * 30))
            a, b = conflicting_pair(stranger, height=1 + i, in_set=False)
            bogus.append(DuplicateVoteEvidence(a, b))
        elif kind == 1:                     # agreement: no equivocation
            priv = privs[rng.randrange(len(privs))]
            a, _ = conflicting_pair(priv, height=1 + i, in_set=True)
            bogus.append(DuplicateVoteEvidence(a, a))
        else:                               # torn signature
            priv = privs[rng.randrange(len(privs))]
            a, b = conflicting_pair(priv, height=1 + i, in_set=True)
            bad = Vote(**{**b.__dict__,
                          "signature": bytes(64)})
            bogus.append(DuplicateVoteEvidence(a, bad))
    ctx.plan("evidence-flood", n_real=n_real, n_bogus=n_bogus)
    return real, bogus


# -- byzantine fast-sync peers ----------------------------------------------

def tamper_block_server(ctx, switch, chain, mode: str,
                        heights: list[int]) -> None:
    """Turn a fastsync_source switch into a byzantine peer that answers
    BlockRequests for scheduled heights with replayed commits:

    - mode="stale": block h is served with the commit of an OLDER height
      spliced in as its last_commit — a stale finality proof (the PoTE
      adversary: yesterday's proof re-presented for today's block)
    - mode="partial": block h's last_commit is pruned to a single
      precommit, far below +2/3 — a partial-commit replay (the ACE
      adversary: a quorum certificate missing most of its power)

    `chain` is the fixture list [(block, part_set, seen_commit)]."""
    if mode not in ("stale", "partial"):
        raise ValueError(f"unknown tamper mode {mode!r}")
    targets = set(heights)
    ctx.plan("tamper-server", mode=mode, heights=sorted(targets))
    reactor = switch.reactor("blockchain")
    orig_receive = reactor.receive

    def evil_last_commit(height: int):
        block = chain[height - 1][0]
        lc = block.last_commit
        if mode == "stale":
            # the seen-commit of an older block: valid signatures, wrong
            # block — exactly what a replayed finality proof looks like
            older = max(height - 3, 1)
            return chain[older - 1][2]
        keep = [v if i == 0 else None for i, v in enumerate(lc.precommits)]
        return type(lc)(block_id=lc.block_id, precommits=keep)

    def tampering_receive(ch_id, peer, raw):
        msg = BM.decode_msg(raw)
        if isinstance(msg, BM.BlockRequest) and msg.height in targets \
                and msg.height > 1:
            block = chain[msg.height - 1][0]
            evil = Block(header=block.header, txs=block.txs,
                         last_commit=evil_last_commit(msg.height))
            ctx.note("tamper.served", height=msg.height, mode=mode)
            peer.try_send(BLOCKCHAIN_CHANNEL,
                          BM.encode_msg(BM.BlockResponse(evil.encode())))
            return
        orig_receive(ch_id, peer, raw)

    reactor.receive = tampering_receive


# -- network faults ---------------------------------------------------------

def sever_inbound(ctx, links: list[FuzzedConnection],
                  stall: float = 1.0, label: str = "") -> None:
    """Partition one direction: every read on these links stalls, so the
    owner stops hearing the network while its own frames still flow.
    Heal with `restore`.  Stalling (not dropping) keeps the
    SecretConnection frame sequence intact, so the link survives the
    partition and resumes cleanly."""
    ctx.note("partition.sever", links=len(links), label=label)
    for fc in links:
        fc.set_profile(read_drop_prob=1.0, read_stall=stall)


def delay_storm(ctx, links: list[FuzzedConnection], delay_prob: float,
                max_delay: float, label: str = "") -> None:
    """Reordering/jitter storm: both directions of these links delay a
    fraction of operations (message reordering across channels follows
    from unequal per-frame delays)."""
    ctx.note("storm.start", links=len(links), delay_prob=delay_prob,
             max_delay=max_delay, label=label)
    for fc in links:
        fc.set_profile(read_delay_prob=delay_prob,
                       write_delay_prob=delay_prob, max_delay=max_delay)


def restore(ctx, links: list[FuzzedConnection], label: str = "") -> None:
    """Heal: zero every fault probability on these links."""
    ctx.note("partition.heal", links=len(links), label=label)
    for fc in links:
        fc.set_profile(read_drop_prob=0.0, read_delay_prob=0.0,
                       write_drop_prob=0.0, write_delay_prob=0.0)


# -- crash-restart ----------------------------------------------------------

def tear_wal_tail(ctx, path: str, rng) -> int:
    """Simulate SIGKILL mid-record-write: append a torn frame — a valid
    header promising `length` bytes followed by only part of the body —
    exactly the on-disk state of a writer killed between write() calls.
    Half the time the existing tail is also cut mid-frame (the page-
    cache variant).  Returns the torn-frame offset."""
    payload = bytes(rng.randrange(256) for _ in range(24))
    body = struct.pack(">B", REC_MESSAGE) + payload
    cut = rng.randrange(1, len(body))
    size = os.path.getsize(path)
    variant = rng.randrange(2)
    with open(path, "r+b") as f:
        if variant and size > 12:
            # cut the last few bytes of the real tail first
            f.truncate(size - rng.randrange(1, 8))
        f.seek(0, os.SEEK_END)
        off = f.tell()
        f.write(struct.pack(">II", len(body), 0xDEADBEEF) + body[:cut])
        f.flush()
        os.fsync(f.fileno())
    ctx.note("wal.torn", path=path, offset=off, cut=cut, variant=variant)
    return off
