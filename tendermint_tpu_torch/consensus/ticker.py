"""Deduplicating consensus timeout timer.

Reference: `consensus/ticker.go` — tick requests for (height, round, step)
only override *older* ones (`:95-131`); fires deliver into the consensus
receive loop.  One timer thread; schedule_timeout replaces the pending
timer iff the new (H,R,S) is newer.  Copy of
`tendermint_tpu/consensus/ticker.py`.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass


@dataclass(frozen=True, order=True)
class TimeoutInfo:
    height: int
    round: int
    step: int            # RoundStep value
    duration: float = 0.0


class TimeoutTicker:
    def __init__(self, fire_cb):
        """fire_cb(TimeoutInfo) is called from the timer thread."""
        self._fire_cb = fire_cb
        self._lock = threading.Lock()
        self._timer: threading.Timer | None = None
        self._pending: TimeoutInfo | None = None
        self._stopped = False

    def schedule_timeout(self, ti: TimeoutInfo) -> None:
        """Override any pending timeout for an older (H,R,S)
        (reference `:108-125`)."""
        with self._lock:
            if self._stopped:
                return
            if self._pending is not None:
                newer = (ti.height, ti.round, ti.step) >= (
                    self._pending.height, self._pending.round,
                    self._pending.step)
                if not newer:
                    return
                self._timer.cancel()
            self._pending = ti
            self._timer = threading.Timer(ti.duration, self._fire, args=(ti,))
            self._timer.daemon = True
            self._timer.start()

    def _fire(self, ti: TimeoutInfo) -> None:
        with self._lock:
            if self._stopped or self._pending is not ti:
                return
            self._pending = None
        self._fire_cb(ti)

    def stop(self) -> None:
        with self._lock:
            self._stopped = True
            if self._timer is not None:
                self._timer.cancel()


class MockTicker:
    """Deterministic ticker for tests (reference
    `consensus/common_test.go:427-466`): timeouts fire only when the test
    calls `fire_next`, or immediately when `auto` is set."""

    def __init__(self, fire_cb, auto: bool = False):
        self._fire_cb = fire_cb
        self._auto = auto
        self._pending: TimeoutInfo | None = None
        self._lock = threading.Lock()

    def schedule_timeout(self, ti: TimeoutInfo) -> None:
        with self._lock:
            self._pending = ti
        if self._auto:
            self._fire_cb(ti)

    def fire_next(self) -> TimeoutInfo | None:
        with self._lock:
            ti, self._pending = self._pending, None
        if ti is not None:
            self._fire_cb(ti)
        return ti

    def stop(self) -> None:
        pass
