"""Transactions and their Merkle commitments.

Reference: `types/tx.go` — `Tx.Hash`, `Txs.Hash` (recursive binary Merkle
over wire bytes, `types/tx.go:29-43`), inclusion proofs (`:66-85`).
"""

from __future__ import annotations

from dataclasses import dataclass

from tendermint_tpu_torch.types import merkle


class Tx(bytes):
    """An opaque transaction; the app defines its meaning."""

    @property
    def hash(self) -> bytes:
        return merkle.leaf_hash(self)


def txs_hash(txs: list[bytes]) -> bytes:
    """Merkle root over transactions (reference `types/tx.go:29-43`)."""
    return merkle.root(list(txs))


def txs_proof(txs: list[bytes], index: int) -> "TxProof":
    rt, proofs = merkle.proofs(list(txs))
    return TxProof(root=rt, tx=Tx(txs[index]), proof=proofs[index])


@dataclass(frozen=True)
class TxProof:
    """Inclusion proof of one tx in a block's data hash
    (reference `types/tx.go:96-109`)."""
    root: bytes
    tx: Tx
    proof: merkle.Proof

    def validate(self, data_hash: bytes) -> bool:
        if data_hash != self.root:
            return False
        if merkle.leaf_hash(self.tx) != self.proof.leaf:
            return False
        return self.proof.verify(self.root)
