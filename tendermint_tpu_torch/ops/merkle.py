"""Batched SHA-256 Merkle roots — the twin of `tendermint_tpu/ops/merkle.py`.

Same roots as the host tree (`types.merkle`: recursive (n+1)//2 split,
0x00 leaf / 0x01 inner domain separation) for a batch of equal-shaped
trees: leaf hashing is one `sha256_prefixed` (kernel K4 on CUDA tensors)
over [..., n, L], and each level is one `sha256_prefixed` over the
(left || right) pairs that the static `_plan(n)` schedule gathers with
torch indexing.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from tendermint_tpu_torch.ops.sha256 import sha256_prefixed

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


def _hash_rows(rows: torch.Tensor, prefix: int) -> torch.Tensor:
    """sha256(prefix || row) over the last axis of [..., L] -> [..., 32]."""
    flat = rows.reshape(-1, rows.shape[-1]).contiguous()
    return sha256_prefixed(flat, prefix).reshape(rows.shape[:-1] + (32,))


def leaf_hashes(data: torch.Tensor) -> torch.Tensor:
    """uint8[..., n, L] -> leaf hashes uint8[..., n, 32] (0x00-prefixed)."""
    return _hash_rows(data, LEAF_PREFIX)


def root_from_leaf_hashes(h: torch.Tensor) -> torch.Tensor:
    """uint8[..., n, 32] leaf hashes -> root uint8[..., 32]."""
    n = h.shape[-2]
    if n == 0:
        raise ValueError("empty tree has a constant root; hash host-side")
    for pairs, singles in _plan(n):
        idx = torch.as_tensor(pairs, dtype=torch.long, device=h.device)
        both = torch.cat([h[..., idx[:, 0], :], h[..., idx[:, 1], :]], -1)
        combined = _hash_rows(both, INNER_PREFIX)
        if len(singles):
            keep = torch.as_tensor(singles, dtype=torch.long, device=h.device)
            h = torch.cat([combined, h[..., keep, :]], dim=-2)
        else:
            h = combined
    return h[..., 0, :]


def roots(data: torch.Tensor) -> torch.Tensor:
    """uint8[..., n, L] equal-length leaves -> roots uint8[..., 32]."""
    return root_from_leaf_hashes(leaf_hashes(data))
