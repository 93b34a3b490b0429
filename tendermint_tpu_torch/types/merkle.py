"""SHA-256 simple Merkle tree — host reference implementation.

Tree shape follows the reference exactly (reference `types/tx.go:29-43`,
tmlibs/merkle SimpleTree): leaves are hashed individually, and an n-leaf
tree splits into a floor((n+1)/2) left subtree and the remainder right —
so proofs and roots match between host and the batched device kernel
(`tendermint_tpu_torch.ops.merkle`), which is differential-tested against this.

The reference era used RIPEMD-160; this framework standardizes on SHA-256
(see SURVEY.md §2.2 PartSet note).  Leaf/inner domain separation prevents
second-preimage attacks (a hardening the reference lacks).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

LEAF_PREFIX = b"\x00"
INNER_PREFIX = b"\x01"


def _sha(b: bytes) -> bytes:
    return hashlib.sha256(b).digest()


def leaf_hash(data: bytes) -> bytes:
    return _sha(LEAF_PREFIX + data)


def inner_hash(left: bytes, right: bytes) -> bytes:
    return _sha(INNER_PREFIX + left + right)


def _split(n: int) -> int:
    """Left-subtree size for n leaves: the reference's (n+1)//2 split
    (reference `types/tx.go:33`)."""
    return (n + 1) // 2


def root_from_leaf_hashes(hashes: list[bytes]) -> bytes:
    if not hashes:
        return _sha(b"")
    if len(hashes) == 1:
        return hashes[0]
    k = _split(len(hashes))
    return inner_hash(root_from_leaf_hashes(hashes[:k]),
                      root_from_leaf_hashes(hashes[k:]))


def root(items: list[bytes]) -> bytes:
    """Merkle root over raw byte items."""
    return root_from_leaf_hashes([leaf_hash(i) for i in items])


def root_of_map(kvs: dict[str, bytes]) -> bytes:
    """Deterministic root over a string->bytes map: items are
    lp(key)||lp(value) sorted by key (the reference's SimpleHashFromMap,
    used for `Header.Hash`, reference `types/block.go:178-193`)."""
    items = []
    for k in sorted(kvs):
        kb = k.encode()
        v = kvs[k]
        items.append(len(kb).to_bytes(4, "big") + kb +
                     len(v).to_bytes(4, "big") + v)
    return root(items)


@dataclass(frozen=True)
class Proof:
    """Inclusion proof: sibling hashes from leaf to root.

    `aunts[i]` is the sibling at depth i counting from the leaf; `index` /
    `total` fix the path shape (reference `types/part_set.go:188-214`).
    """
    total: int
    index: int
    leaf: bytes          # leaf *hash*
    aunts: tuple[bytes, ...]

    def compute_root(self) -> bytes:
        return _compute_from_aunts(self.index, self.total, self.leaf,
                                   list(self.aunts))

    def verify(self, expected_root: bytes) -> bool:
        if not (0 <= self.index < self.total):
            return False
        try:
            return self.compute_root() == expected_root
        except (ValueError, IndexError):
            # IndexError: proof carries fewer aunts than the path depth
            return False


def _compute_from_aunts(index: int, total: int, leaf: bytes,
                        aunts: list[bytes]) -> bytes:
    assert total >= 1
    if total == 1:
        if aunts:
            raise ValueError("unexpected aunts for single leaf")
        return leaf
    k = _split(total)
    if index < k:
        left = _compute_from_aunts(index, k, leaf, aunts[:-1])
        return inner_hash(left, aunts[-1])
    right = _compute_from_aunts(index - k, total - k, leaf, aunts[:-1])
    return inner_hash(aunts[-1], right)


def proofs(items: list[bytes]) -> tuple[bytes, list[Proof]]:
    """Root plus one inclusion proof per item."""
    return proofs_from_leaf_hashes([leaf_hash(i) for i in items])


def proofs_from_leaf_hashes(hashes: list[bytes]) -> tuple[bytes, list[Proof]]:
    """Root + proofs from precomputed leaf hashes — the seam that lets the
    bulk leaf hashing run on the device (`ops.merkle.leaf_hashes`) while
    the irregular tree/proof assembly stays host-side."""
    n = len(hashes)
    if n == 0:
        return root([]), []
    trails: list[list[bytes]] = [[] for _ in range(n)]

    def build(lo: int, hi: int) -> bytes:
        if hi - lo == 1:
            return hashes[lo]
        k = _split(hi - lo)
        left = build(lo, lo + k)
        right = build(lo + k, hi)
        for i in range(lo, lo + k):
            trails[i].append(right)
        for i in range(lo + k, hi):
            trails[i].append(left)
        return inner_hash(left, right)

    rt = build(0, n)
    return rt, [Proof(n, i, hashes[i], tuple(trails[i])) for i in range(n)]
