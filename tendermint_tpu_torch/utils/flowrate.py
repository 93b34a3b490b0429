"""Byte-rate metering for connections and fast-sync peers.

Copy of `tendermint_tpu/utils/flowrate.py`, with `Meter.unbiased_rate` added
for the block pool's rate rule.

Reference: tmlibs/flowrate `Monitor` — the reference samples transfer
progress into an EMA and exposes `Status{AvgRate, Bytes, ...}`; fast-sync
evicts peers whose receive rate falls under 10 KB/s
(`blockchain/pool.go:14-19,100-118`) and `net_info` exposes per-connection
send/recv snapshots (`p2p/connection.go:485-515`).  This is a compact
equivalent: fixed sampling windows folded into an exponential moving
average, lock-free enough for per-packet updates.
"""

from __future__ import annotations

import threading
import time

_WINDOW = 0.25      # seconds per sample window
_ALPHA = 0.1        # EMA weight of the newest window — slow enough that
                    # a healthy peer mid-transfer (bytes land only on
                    # block completion) does not decay under an eviction
                    # threshold within a couple of empty windows


class Meter:
    """Exponentially-averaged byte rate plus totals."""

    def __init__(self, now: float | None = None):
        self._lock = threading.Lock()
        self._start = now if now is not None else time.monotonic()
        self._window_start = self._start
        self._window_bytes = 0
        self._rate = 0.0
        self.total = 0

    def update(self, nbytes: int, now: float | None = None) -> None:
        now = now if now is not None else time.monotonic()
        with self._lock:
            self.total += nbytes
            self._roll(now)
            self._window_bytes += nbytes

    def _roll(self, now: float) -> None:
        elapsed = now - self._window_start
        if elapsed < _WINDOW:
            return
        n = int(elapsed / _WINDOW)
        sample = self._window_bytes / _WINDOW
        self._rate = (_ALPHA * sample + (1 - _ALPHA) * self._rate
                      if self._rate or sample else 0.0)
        if n > 1:
            # the remaining n-1 windows are empty: decay in closed form
            # instead of iterating (an hour-idle meter would otherwise
            # spin ~14k loop iterations under the lock)
            self._rate *= (1 - _ALPHA) ** (n - 1)
        self._window_bytes = 0
        self._window_start += n * _WINDOW

    def rate(self, now: float | None = None) -> float:
        """Bytes/second, exponentially averaged over recent windows."""
        now = now if now is not None else time.monotonic()
        with self._lock:
            self._roll(now)
            return self._rate

    def unbiased_rate(self, now: float | None = None) -> float:
        """`rate()` without the average's bias toward its zero start: the
        average divided by the weight its windows so far carry, 1 - (1 -
        _ALPHA) ** windows.  A young meter then reads the mean rate of
        what it has seen, not a fraction of it; an old one reads as
        `rate()`."""
        now = now if now is not None else time.monotonic()
        with self._lock:
            self._roll(now)
            windows = round((self._window_start - self._start) / _WINDOW)
            if windows == 0:
                return self._rate
            return self._rate / (1 - (1 - _ALPHA) ** windows)

    def age(self, now: float | None = None) -> float:
        now = now if now is not None else time.monotonic()
        return now - self._start

    def status(self) -> dict:
        return {"rate_bytes_per_sec": round(self.rate(), 1),
                "total_bytes": self.total,
                "age_seconds": round(self.age(), 2)}
