"""Traffic of kind "grid": header+commit pairs for a relay to verify.

The shape of the program's light-grid fixture (`chip_smoke.py`
`light_chains`), made by the benchmark from `--seed`: per chain of the
configuration, its own set of `validators` keys and `headers_per_call`
headers with random block and part-set hashes (one part), each commit
signed by every validator through `signer` (the program's K3 on the
card).  Two chains each carry one forged signature, the first at a lane
of the first half of its call's K1 launch and the second of the second
half, so each of those chains' calls must be refused at its height and
lane; every other call is accepted.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from bftbench.reference import chain as ref
from bftbench.reference import ed25519
from bftbench.traffic.chain import forged_lanes


@dataclass
class GridChain:
    chain_id: str
    pubs: list                 # in validator-set order
    hashes: np.ndarray         # uint8[H, 2, 32]: block hash, parts hash
    templates: np.ndarray      # uint8[H, 128]
    sigs: np.ndarray           # uint8[H, V, 64]


@dataclass
class Grid:
    chains: list
    power: int
    forged: list               # per forged chain: (chain, height, lane)


def generate(seed: int, mix: dict, config: dict, device, signer) -> Grid:
    n_chains, n_vals = config["chains"], config["validators"]
    headers = mix["headers_per_call"]
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    raw = torch.randint(0, 256, (n_chains, n_vals, 32), generator=g,
                        device=device, dtype=torch.uint8).cpu().numpy()
    hashes = torch.randint(0, 256, (n_chains, headers, 2, 32), generator=g,
                           device=device, dtype=torch.uint8).cpu().numpy()
    pick = lambda lo, hi: int(torch.randint(  # noqa: E731
        lo, hi, (1,), generator=g, device=device).item())
    first = pick(0, n_chains)
    at = [first, (first + pick(1, n_chains)) % n_chains]
    forged = [(c, p // n_vals + 1, p % n_vals) for c, p in
              zip(at, forged_lanes(headers * n_vals, pick))]
    chains = []
    for c in range(n_chains):
        seeds = [raw[c, i].tobytes() for i in range(n_vals)]
        pubs = [ed25519.pubkey(s) for s in seeds]
        order = ref.set_order(pubs)
        pubs, seeds = [pubs[i] for i in order], [seeds[i] for i in order]
        cid = f"{config['chain_id']}-{c}"
        templates = ref.sign_bytes(cid, np.arange(1, headers + 1),
                                   hashes[c, :, 0], hashes[c, :, 1],
                                   np.ones(headers, np.int64))
        sigs = sign_all(signer, seeds, templates)
        for fc, fh, fl in forged:
            if fc == c:
                sigs[fh - 1, fl, 0] ^= 1
        chains.append(GridChain(cid, pubs, hashes[c], templates, sigs))
    return Grid(chains, config["power"], forged)


def sign_all(signer, seeds: list, templates: np.ndarray,
             chunk_lanes: int = 65_500) -> np.ndarray:
    """uint8[T, V, 64]: every validator's signature of every template,
    in calls of at most `chunk_lanes` lanes (K3's bucket)."""
    n_vals, n = len(seeds), len(templates)
    step = max(1, chunk_lanes // n_vals)
    sigs = np.zeros((n, n_vals, 64), np.uint8)
    vi = np.tile(np.arange(n_vals, dtype=np.int32), step)
    ti = np.repeat(np.arange(step, dtype=np.int32), n_vals)
    for off in range(0, n, step):
        k = min(step, n - off)
        sigs[off:off + k] = signer(seeds, vi[:k * n_vals], ti[:k * n_vals],
                                   templates[off:off + k]).reshape(
            k, n_vals, 64)
    return sigs
