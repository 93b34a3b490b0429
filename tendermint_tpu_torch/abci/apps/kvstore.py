"""kvstore ("dummy") app: the reference's default test application.

Reference: abci example dummy app (used via `--proxy_app=dummy`,
`proxy/client.go:65-73`): txs are `key=value` (or `value` meaning
`value=value`); state is a map; app hash commits to the contents.
Persistent variant stores to disk and survives restarts, reporting its
last height in Info for handshake replay.  Copy of
`tendermint_tpu/abci/apps/kvstore.py`; the persistent variant takes its
file as an argument (the node passes `<data dir>/kvstore_app.json`), and
no `TM_KVSTORE_PATH` environment variable names it.
"""

from __future__ import annotations

import hashlib
import json
import os

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

    # -- state sync -----------------------------------------------------
    def snapshot_state(self) -> bytes:
        """Full state as u64(height) || (lp(k) || lp(v))* sorted by key —
        deterministic, so two nodes at the same height serialize the
        identical blob (and the identical snapshot chunk hashes)."""
        out = [self.height.to_bytes(8, "big")]
        for k in sorted(self.state):
            v = self.state[k]
            out.append(len(k).to_bytes(4, "big") + k)
            out.append(len(v).to_bytes(4, "big") + v)
        return b"".join(out)

    def restore_state(self, data: bytes) -> None:
        """Rebuild from a snapshot blob.  Buckets are filled first and
        digested ONCE each: restoring through `_set` would re-hash each
        growing bucket per key — O(state²/256), i.e. as slow as replaying
        every tx, which defeats the point of a snapshot."""
        height = int.from_bytes(data[:8], "big")
        off, n = 8, len(data)
        state: dict[bytes, bytes] = {}
        while off < n:
            klen = int.from_bytes(data[off:off + 4], "big")
            k = data[off + 4:off + 4 + klen]
            off += 4 + klen
            vlen = int.from_bytes(data[off:off + 4], "big")
            v = data[off + 4:off + 4 + vlen]
            off += 4 + vlen
            if len(k) != klen or len(v) != vlen:
                raise ValueError("truncated kvstore snapshot blob")
            state[k] = v
        self.state = state
        self.height = height
        self._buckets = [{} for _ in range(N_BUCKETS)]
        self._bucket_digest = [bytes(32)] * N_BUCKETS
        for k, v in state.items():
            self._buckets[hashlib.sha256(k).digest()[0]][k] = v
        for b in range(N_BUCKETS):
            if self._buckets[b]:
                self._rehash_bucket(b)


class PersistentKVStoreApp(KVStoreApp):
    """Disk-backed variant (reference `persistent_dummy`): Info() reports
    the persisted height for handshake replay.  `db_path` is the JSON
    file it keeps its state in."""

    def __init__(self, db_path: str):
        super().__init__()
        self.db_path = db_path
        self._load()

    def _load(self):
        if os.path.exists(self.db_path):
            with open(self.db_path) as f:
                d = json.load(f)
            self.height = d["height"]
            # bucket-first load, one digest pass per bucket (same
            # reasoning as restore_state: per-key _set is quadratic)
            for k, v in d["state"].items():
                kb, vb = bytes.fromhex(k), bytes.fromhex(v)
                self.state[kb] = vb
                self._buckets[hashlib.sha256(kb).digest()[0]][kb] = vb
            for b in range(N_BUCKETS):
                if self._buckets[b]:
                    self._rehash_bucket(b)

    def commit(self) -> Result:
        res = super().commit()
        self.persist_state()
        return res

    def persist_state(self) -> None:
        """Write the current state to disk (tmp + fsync + rename).
        Commit's persistence step, also called directly after a
        snapshot restore_state (which bypasses commit)."""
        tmp = self.db_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"height": self.height,
                       "state": {k.hex(): v.hex()
                                 for k, v in self.state.items()}}, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.db_path)


register_app("kvstore", KVStoreApp)
register_app("dummy", KVStoreApp)
register_app("persistent_kvstore", PersistentKVStoreApp)
register_app("persistent_dummy", PersistentKVStoreApp)
register_app("nilapp", Application)
