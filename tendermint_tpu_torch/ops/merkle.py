"""Batched SHA-256 Merkle roots — the twin of `tendermint_tpu/ops/merkle.py`,
and the wrapper of kernel K7 (`csrc/merkle_roots.cu`).

Same roots as the host tree (`types.merkle`: recursive (n+1)//2 split,
0x00 leaf / 0x01 inner domain separation) for a batch of equal-shaped
trees.  `roots` and `root_from_leaf_hashes` launch K7 on a CUDA tensor:
each tree in one block, walking the flat schedule `plan_table(n)`, which
is uploaded once per (n, device).  On a CPU tensor they run their plain
versions, `roots_plain` / `root_from_leaf_hashes_plain`: one plain
`sha256_prefixed` over the leaves, then per level of the static `_plan(n)`
schedule one over the (left || right) pairs that torch indexing gathers.
`leaf_hashes` is one `sha256_prefixed` (kernel K4 on a CUDA tensor).
"""

from __future__ import annotations

import functools
import math
import threading

import numpy as np
import torch

from tendermint_tpu_torch.ops import kernels
from tendermint_tpu_torch.ops.sha256 import (sha256_prefixed,
                                             sha256_prefixed_plain)

LEAF_PREFIX = 0x00
INNER_PREFIX = 0x01


class _Node:
    __slots__ = ("left", "right", "parent", "height")

    def __init__(self, left=None, right=None):
        self.left, self.right = left, right
        self.parent = None
        self.height = 0 if left is None else 1 + max(left.height,
                                                     right.height)
        for c in (left, right):
            if c is not None:
                c.parent = self


@functools.lru_cache(maxsize=None)
def _plan(n: int) -> tuple:
    """Level schedule for an n-leaf reference-shaped tree (a copy of the
    reference's `merkle._plan`).

    Returns a tuple of steps; step s is (pairs, singles): pairs int32[m, 2]
    indexes the previous level's array for (left, right) children of every
    height-s node, singles int32[k] indexes nodes passing through because
    their parent combines at a later step.  The next level's array is the
    pair outputs followed by the singles, in DFS order each.
    """
    if n == 0:
        return ()

    def build(lo: int, hi: int) -> _Node:
        if hi - lo == 1:
            return _Node()
        k = (hi - lo + 1) // 2
        return _Node(build(lo, lo + k), build(lo + k, hi))

    root = build(0, n)
    order: dict[_Node, int] = {}

    def dfs(node: _Node):
        order[node] = len(order)
        if node.left is not None:
            dfs(node.left)
            dfs(node.right)

    dfs(root)

    by_height: dict[int, list[_Node]] = {}
    for node in order:
        by_height.setdefault(node.height, []).append(node)
    for nodes in by_height.values():
        nodes.sort(key=order.__getitem__)

    current = by_height[0]
    slot = {node: i for i, node in enumerate(current)}
    steps = []
    for s in range(1, root.height + 1):
        combined = by_height.get(s, [])
        pairs = np.asarray([[slot[nd.left], slot[nd.right]]
                            for nd in combined], dtype=np.int32).reshape(-1, 2)
        singles_nodes = [nd for nd in current
                         if nd.parent is not None and nd.parent.height != s]
        singles = np.asarray([slot[nd] for nd in singles_nodes],
                             dtype=np.int32)
        current = combined + singles_nodes
        slot = {node: i for i, node in enumerate(current)}
        steps.append((pairs, singles))
    if len(current) != 1:
        raise AssertionError("merkle plan did not reduce to one root")
    return tuple(steps)


@functools.lru_cache(maxsize=None)
def plan_table(n: int) -> np.ndarray:
    """`_plan(n)` as K7 walks it: one flat int32 array holding, per level,
    m (the pairs), k (the singles), then the m (left, right) pairs and the
    k singles."""
    flat = [np.zeros(0, np.int32)]
    for pairs, singles in _plan(n):
        flat += [np.array([len(pairs), len(singles)], np.int32),
                 pairs.reshape(-1), singles]
    return np.concatenate(flat).astype(np.int32)


# Dynamic shared memory a block can have on Hopper (227 KB): K7 keeps its
# two node buffers (2 x n x 32 B) there while they fit, else in scratch.
MAX_SHARED_BYTES = 232448

_device_plans: dict = {}
_plans_lock = threading.Lock()


def _device_plan(n: int, device: torch.device) -> torch.Tensor:
    """`plan_table(n)` on `device`, uploaded at its first use only."""
    with _plans_lock:
        t = _device_plans.get((n, device))
        if t is None:
            t = torch.as_tensor(plan_table(n), device=device)
            _device_plans[(n, device)] = t
    return t


def _hash_rows(rows: torch.Tensor, prefix: int, fn=sha256_prefixed):
    """fn(prefix || row) over the last axis of [..., L] -> [..., 32]."""
    flat = rows.reshape(math.prod(rows.shape[:-1]), rows.shape[-1])
    return fn(flat.contiguous(), prefix).reshape(rows.shape[:-1] + (32,))


def leaf_hashes(data: torch.Tensor) -> torch.Tensor:
    """uint8[..., n, L] -> leaf hashes uint8[..., n, 32] (0x00-prefixed)."""
    return _hash_rows(data, LEAF_PREFIX)


def _check_trees(x: torch.Tensor, name: str) -> int:
    if x.dtype != torch.uint8 or x.dim() < 2:
        raise ValueError(f"{name}: expected uint8[..., n, L], got "
                         f"{x.dtype} {tuple(x.shape)}")
    n = x.shape[-2]
    if n == 0:
        raise ValueError("empty tree has a constant root; hash host-side")
    return n


def root_from_leaf_hashes_plain(h: torch.Tensor) -> torch.Tensor:
    """Plain version of K7 on given leaf hashes: uint8[..., n, 32] ->
    root uint8[..., 32], level by level (reference
    `merkle.root_from_leaf_hashes`)."""
    n = _check_trees(h, "leaf hashes")
    for pairs, singles in _plan(n):
        idx = torch.as_tensor(pairs, dtype=torch.long, device=h.device)
        both = torch.cat([h[..., idx[:, 0], :], h[..., idx[:, 1], :]], -1)
        combined = _hash_rows(both, INNER_PREFIX, sha256_prefixed_plain)
        if len(singles):
            keep = torch.as_tensor(singles, dtype=torch.long, device=h.device)
            h = torch.cat([combined, h[..., keep, :]], dim=-2)
        else:
            h = combined
    return h[..., 0, :]


def roots_plain(data: torch.Tensor) -> torch.Tensor:
    """Plain version of K7: uint8[..., n, L] equal-length leaves -> roots
    uint8[..., 32] (reference `merkle.roots`)."""
    _check_trees(data, "leaves")
    return root_from_leaf_hashes_plain(
        _hash_rows(data, LEAF_PREFIX, sha256_prefixed_plain))


def _launch_roots(x: torch.Tensor, hashed: bool) -> torch.Tensor:
    n, width = x.shape[-2:]
    flat = x.reshape(math.prod(x.shape[:-2]), n, width).contiguous()
    trees = flat.shape[0]
    out = torch.empty((trees, 32), dtype=torch.uint8, device=x.device)
    if trees:
        plan = _device_plan(n, x.device)
        shared = 2 * n * 32 <= MAX_SHARED_BYTES
        scratch = torch.empty(0 if shared else trees * 2 * n * 8,
                              dtype=torch.int32, device=x.device)
        kernels.launch("merkle_roots", flat, n, width, int(hashed), plan,
                       plan.numel(), scratch, int(shared), out, trees)
    return out.reshape(x.shape[:-2] + (32,))


def root_from_leaf_hashes(h: torch.Tensor) -> torch.Tensor:
    """uint8[..., n, 32] leaf hashes -> root uint8[..., 32].  K7 on a
    CUDA tensor; the plain version on a CPU tensor."""
    _check_trees(h, "leaf hashes")
    if h.shape[-1] != 32:
        raise ValueError(f"leaf hashes: expected 32 bytes each, got "
                         f"{h.shape[-1]}")
    if h.device.type == "cpu":
        return root_from_leaf_hashes_plain(h)
    return _launch_roots(h, hashed=True)


def roots(data: torch.Tensor) -> torch.Tensor:
    """uint8[..., n, L] equal-length leaves -> roots uint8[..., 32].  K7
    on a CUDA tensor; the plain version on a CPU tensor."""
    _check_trees(data, "leaves")
    if data.device.type == "cpu":
        return roots_plain(data)
    return _launch_roots(data, hashed=False)
