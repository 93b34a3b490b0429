"""Transaction indexing: look up committed txs by hash.

Reference: `state/txindex/` — `TxIndexer` interface (`indexer.go:10-50`),
kv impl storing encoded results by tx hash (`kv/kv.go`), null no-op
(`null/null.go`); selected in `node/node.go:96-104`.  Copy of
`tendermint_tpu/state/txindex.py`.
"""

from __future__ import annotations

from dataclasses import dataclass

from tendermint_tpu_torch.abci.types import Result
from tendermint_tpu_torch.types.codec import Reader, lp_bytes, u32, u64
from tendermint_tpu_torch.types.tx import Tx


@dataclass
class TxResult:
    height: int
    index: int
    tx: bytes
    result: Result

    def encode(self) -> bytes:
        return (u64(self.height) + u32(self.index) + lp_bytes(self.tx) +
                self.result.encode())

    @classmethod
    def decode_bytes(cls, data: bytes) -> "TxResult":
        r = Reader(data)
        out = cls(height=r.u64(), index=r.u32(), tx=r.lp_bytes(),
                  result=Result.decode(r))
        r.expect_done()
        return out


class NullTxIndexer:
    """No-op (reference `null/null.go`)."""

    def index_block(self, block, abci_responses) -> None:
        pass

    def get(self, tx_hash: bytes) -> TxResult | None:
        return None


class KVTxIndexer:
    """Stores TxResult by tx hash (reference `kv/kv.go`)."""

    def __init__(self, db):
        self.db = db

    def index_block(self, block, abci_responses) -> None:
        kvs = []
        for i, (tx, res) in enumerate(zip(block.txs,
                                          abci_responses.deliver_txs)):
            tr = TxResult(height=block.height, index=i, tx=tx, result=res)
            kvs.append((b"tx:" + Tx(tx).hash, tr.encode()))
        self.db.set_batch(kvs)

    def get(self, tx_hash: bytes) -> TxResult | None:
        raw = self.db.get(b"tx:" + tx_hash)
        return TxResult.decode_bytes(raw) if raw else None
