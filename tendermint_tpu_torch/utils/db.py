"""Key-value store: the in-memory store of `tendermint_tpu/utils/db.py`.

Reference: tmlibs/db memdb.  The durable sqlite store waits for a later
slice of the port.
"""

from __future__ import annotations

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
