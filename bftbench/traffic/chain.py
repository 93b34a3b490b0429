"""Traffic of kind "chain": a hash-linked chain for a node to fast-sync.

Made by the benchmark from `--seed`: `blocks` honest blocks of
`txs_per_block` kvstore txs of `tx_bytes` random hex characters each (no
"=", so the kvstore keys each tx by itself: every tx writes a key of its
own and the app's state grows with the chain, as under a load generator,
whose txs are distinct because the mempool's cache refuses repeats).
Every block carries its predecessor's commit, signed by every validator,
as its last commit, so the chain is built height by height: block h's
hash needs block h-1's signatures.  Then `tip_blocks` more blocks, the
tip that faulty peers serve: two versions of their seen commits, each
with one forged signature, the first at a lane of the first half of the
tip's K1 launch and the second of its second half, which the node must
refuse, each at its height and lane.  Every signature is made by
`signer` (the program's K3 on the card), a call per height.  The wire
bytes, hashes, part-set headers and app hashes come from the reference
(`reference/chain.py`), which judges the replay.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from bftbench.reference import chain as ref
from bftbench.reference import ed25519

GENESIS_TIME_NS = 1_000_000_000
HEX = np.frombuffer(b"0123456789abcdef", np.uint8)


@dataclass
class SyncChain:
    chain_id: str
    pubs: list                 # in validator-set order
    seeds: list                # in validator-set order
    power: int
    blocks: int                # honest blocks; the tip follows
    window: int
    wire: list                 # wire bytes of heights 1 .. blocks + tip
    block_hash: list
    parts: list                # (total, root) per height
    app_hash: list             # app_hash[h]: after height h (app_hash[0] b"")
    sigs: np.ndarray           # uint8[heights, V, 64] honest seen commits
    tip_sigs: list             # per tip: uint8[tip, V, 64] its seen commits
    forged: list               # per tip: (height, lane) of its forged lane

    @property
    def heights(self) -> int:
        return len(self.wire)


def forged_lanes(n: int, pick) -> list:
    """Two lane positions among a launch's `n` lanes: one of the first
    half and one of the second, as the launch pads its lanes to a power
    of two and as its `n` real lanes split.  `pick(lo, hi)` draws one of
    [lo, hi)."""
    half = (1 << (n - 1).bit_length()) // 2
    return [pick(0, min(n // 2, half)), pick(max(-(-n // 2), half), n)]


def tx_bytes_of(g: torch.Generator, device, heights: int, txs: int,
                tx_bytes: int) -> np.ndarray:
    """uint8[heights, txs, tx_bytes] random hex characters in one draw."""
    nib = torch.randint(0, 16, (heights, txs, tx_bytes), generator=g,
                        device=device, dtype=torch.uint8).cpu().numpy()
    return HEX[nib]


def generate(seed: int, mix: dict, config: dict, device, signer) -> SyncChain:
    n_vals, power = config["validators"], config["power"]
    window = config["window"]
    blocks, tip = mix["blocks"], mix["tip_blocks"]
    heights = blocks + tip
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    raw = torch.randint(0, 256, (n_vals, 32), generator=g, device=device,
                        dtype=torch.uint8).cpu().numpy()
    body = tx_bytes_of(g, device, heights, mix["txs_per_block"],
                       mix["tx_bytes"])
    pick = lambda lo, hi: int(torch.randint(  # noqa: E731
        lo, hi, (1,), generator=g, device=device).item())
    forged_at = forged_lanes(tip * n_vals, pick)
    seeds = [raw[i].tobytes() for i in range(n_vals)]
    pubs = [ed25519.pubkey(s) for s in seeds]
    order = ref.set_order(pubs)
    pubs, seeds = [pubs[i] for i in order], [seeds[i] for i in order]
    addresses = [ref.address(p) for p in pubs]
    chain_id = config["chain_id"]
    vals_hash = ref.validators_hash(pubs, [power] * n_vals)

    kv = ref.KVStore()
    wire, hashes, parts, apps = [], [], [], [b""]
    sigs = np.zeros((heights, n_vals, 64), np.uint8)
    last = (b"", 0, b"")
    val_idx = np.arange(n_vals, dtype=np.int32)
    tmpl_idx = np.zeros(n_vals, np.int32)
    for h in range(1, heights + 1):
        txs = [row.tobytes() for row in body[h - 1]]
        commit = ref.last_commit(h, last, addresses,
                                 sigs[h - 2] if h > 1 else None)
        data, bh = ref.make_block(chain_id, h, GENESIS_TIME_NS + h, txs,
                                  last, vals_hash, apps[-1], commit)
        for tx in txs:
            kv.deliver(tx)
        apps.append(kv.commit())
        pt, ph = ref.part_set_header(data)
        wire.append(data)
        hashes.append(bh)
        parts.append((pt, ph))
        last = (bh, pt, ph)
        template = ref.sign_bytes(
            chain_id, [h], np.frombuffer(bh, np.uint8)[None],
            np.frombuffer(ph, np.uint8)[None], [pt])
        sigs[h - 1] = signer(seeds, val_idx, tmpl_idx, template)

    tip_sigs, forged = [], []
    for p in forged_at:
        s = sigs[blocks:].copy()
        s[p // n_vals, p % n_vals, 0] ^= 1         # R no longer matches
        tip_sigs.append(s)
        forged.append((blocks + 1 + p // n_vals, p % n_vals))
    return SyncChain(chain_id, pubs, seeds, power, blocks, window, wire,
                     hashes, parts, apps, sigs, tip_sigs, forged)

