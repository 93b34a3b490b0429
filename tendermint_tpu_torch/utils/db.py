"""Key-value stores: copy of `tendermint_tpu/utils/db.py`.

Reference: tmlibs/db (goleveldb / memdb, selected by `DBBackend`,
`config/config.go:102,121`).  sqlite3 is the stdlib's durable engine —
single-writer, WAL-journaled, crash-safe — for the block store and the
state store.
"""

from __future__ import annotations

import sqlite3
import threading


class MemDB:
    """In-memory store (reference memdb): tests and throwaway nodes."""

    def __init__(self):
        self._d: dict[bytes, bytes] = {}
        self._lock = threading.Lock()

    def get(self, key: bytes) -> bytes | None:
        with self._lock:
            return self._d.get(key)

    def set(self, key: bytes, value: bytes) -> None:
        with self._lock:
            self._d[key] = value

    def set_batch(self, kvs: list[tuple[bytes, bytes]]) -> None:
        with self._lock:
            self._d.update(kvs)

    def delete(self, key: bytes) -> None:
        with self._lock:
            self._d.pop(key, None)

    def iterate_prefix(self, prefix: bytes):
        with self._lock:
            items = [(k, v) for k, v in self._d.items()
                     if k.startswith(prefix)]
        return sorted(items)

    def close(self) -> None:
        pass


class SQLiteDB:
    """Durable store: one `kv` table, WAL mode, synchronous=NORMAL; one
    connection per thread."""

    def __init__(self, path: str):
        self.path = path
        self._local = threading.local()
        conn = self._conn()
        conn.execute("CREATE TABLE IF NOT EXISTS kv "
                     "(k BLOB PRIMARY KEY, v BLOB NOT NULL)")
        conn.execute("PRAGMA journal_mode=WAL")
        conn.execute("PRAGMA synchronous=NORMAL")
        conn.commit()

    def _conn(self) -> sqlite3.Connection:
        conn = getattr(self._local, "conn", None)
        if conn is None:
            conn = sqlite3.connect(self.path)
            self._local.conn = conn
        return conn

    def get(self, key: bytes) -> bytes | None:
        row = self._conn().execute("SELECT v FROM kv WHERE k=?",
                                   (key,)).fetchone()
        return row[0] if row else None

    def set(self, key: bytes, value: bytes) -> None:
        conn = self._conn()
        conn.execute("INSERT OR REPLACE INTO kv VALUES (?,?)", (key, value))
        conn.commit()

    def set_batch(self, kvs: list[tuple[bytes, bytes]]) -> None:
        conn = self._conn()
        conn.executemany("INSERT OR REPLACE INTO kv VALUES (?,?)", kvs)
        conn.commit()

    def delete(self, key: bytes) -> None:
        conn = self._conn()
        conn.execute("DELETE FROM kv WHERE k=?", (key,))
        conn.commit()

    def iterate_prefix(self, prefix: bytes):
        hi = _prefix_upper_bound(prefix)
        if hi is None:   # prefix is all 0xff (or empty): no upper bound
            return self._conn().execute(
                "SELECT k, v FROM kv WHERE k >= ? ORDER BY k",
                (prefix,)).fetchall()
        return self._conn().execute(
            "SELECT k, v FROM kv WHERE k >= ? AND k < ? ORDER BY k",
            (prefix, hi)).fetchall()

    def close(self) -> None:
        """Close this thread's connection."""
        conn = getattr(self._local, "conn", None)
        if conn is not None:
            conn.close()
            self._local.conn = None


def _prefix_upper_bound(prefix: bytes) -> bytes | None:
    """Smallest byte string greater than every key with this prefix."""
    p = bytearray(prefix)
    while p and p[-1] == 0xFF:
        p.pop()
    if not p:
        return None
    p[-1] += 1
    return bytes(p)


def new_db(backend: str, path: str | None = None):
    """Factory (reference `config/config.go:102` DBBackend)."""
    if backend == "memdb":
        return MemDB()
    if backend == "sqlite":
        if not path:
            raise ValueError("sqlite backend needs a path")
        return SQLiteDB(path)
    raise ValueError(f"unknown db backend {backend!r}")
