"""kvstore ("dummy") app: the reference's default test application.

Reference: abci example dummy app (used via `--proxy_app=dummy`,
`proxy/client.go:65-73`): txs are `key=value` (or `value` meaning
`value=value`); state is a map; app hash commits to the contents.
Copy of `tendermint_tpu/abci/apps/kvstore.py` without the persistent
variant and the snapshot hooks.
"""

from __future__ import annotations

import hashlib

from tendermint_tpu_torch.abci.app import Application, register_app
from tendermint_tpu_torch.abci.types import (OK, ResponseInfo,
                                       ResponseQuery, Result)


N_BUCKETS = 256


class KVStoreApp(Application):
    def __init__(self):
        self.state: dict[bytes, bytes] = {}
        self.height = 0
        # incremental state commitment: keys shard into 256 buckets by
        # key digest; a write re-hashes only its bucket (O(state/256))
        # and the app hash roots the bucket digests.  A full sorted
        # re-hash per commit is O(state) and turns long replays
        # quadratic (the reference dummy app's merkle tree is
        # incremental for the same reason); plain XOR/sum accumulators
        # are LINEAR and therefore forgeable — nested sha256 is not.
        self._buckets: list[dict[bytes, bytes]] = [
            {} for _ in range(N_BUCKETS)]
        self._bucket_digest = [bytes(32)] * N_BUCKETS

    def _set(self, k: bytes, v: bytes) -> None:
        b = hashlib.sha256(k).digest()[0]
        self.state[k] = v
        self._buckets[b][k] = v
        self._rehash_bucket(b)

    def _rehash_bucket(self, b: int) -> None:
        bucket = self._buckets[b]
        h = hashlib.sha256()
        for bk in sorted(bucket):
            bv = bucket[bk]
            h.update(len(bk).to_bytes(4, "big") + bk)
            h.update(len(bv).to_bytes(4, "big") + bv)
        self._bucket_digest[b] = h.digest()

    def _app_hash(self) -> bytes:
        return hashlib.sha256(
            b"".join(self._bucket_digest) +
            self.height.to_bytes(8, "big")).digest()[:20]

    def info(self) -> ResponseInfo:
        return ResponseInfo(data=f"{{\"size\":{len(self.state)}}}",
                            last_block_height=self.height,
                            last_block_app_hash=(self._app_hash()
                                                 if self.height else b""))

    def check_tx(self, tx: bytes) -> Result:
        return Result(OK)

    def deliver_tx(self, tx: bytes) -> Result:
        if b"=" in tx:
            k, v = tx.split(b"=", 1)
        else:
            k = v = tx
        self._set(k, v)
        return Result(OK)

    def end_block(self, height: int):
        from tendermint_tpu_torch.abci.types import ResponseEndBlock
        return ResponseEndBlock()

    def commit(self) -> Result:
        self.height += 1
        return Result(OK, data=self._app_hash())

    def query(self, data: bytes, path: str = "/", height: int = 0,
              prove: bool = False) -> ResponseQuery:
        v = self.state.get(data)
        if v is None:
            return ResponseQuery(code=OK, key=data, log="does not exist",
                                 height=self.height)
        return ResponseQuery(code=OK, key=data, value=v, log="exists",
                             height=self.height)


register_app("kvstore", KVStoreApp)
register_app("dummy", KVStoreApp)
register_app("nilapp", Application)
