"""Typed event bus: consensus progress published to RPC subscribers.

Reference: `types/events.go` over tmlibs/events — NewBlock, NewRound(Step),
Polka, (Un)Lock, Vote, Tx:<hash>, ProposalHeartbeat (`:13-35`), with an
`EventCache` that buffers during block finalization and flushes after
commit (`:175-177`; used `consensus/state.go:1317,1339`).

Copy of `tendermint_tpu/types/events.py`: a synchronous pub/sub with
thread-safe subscribe / fire.
"""

from __future__ import annotations

import threading
from collections import defaultdict
from typing import Callable

# -- event keys (reference types/events.go:13-35) -------------------------
NEW_BLOCK = "NewBlock"
NEW_BLOCK_HEADER = "NewBlockHeader"
NEW_ROUND_STEP = "NewRoundStep"
NEW_ROUND = "NewRound"
TIMEOUT_PROPOSE = "TimeoutPropose"
COMPLETE_PROPOSAL = "CompleteProposal"
POLKA = "Polka"
UNLOCK = "Unlock"
LOCK = "Lock"
RELOCK = "Relock"
TIMEOUT_WAIT = "TimeoutWait"
VOTE = "Vote"
PROPOSAL_HEARTBEAT = "ProposalHeartbeat"


def event_tx(tx_hash: bytes) -> str:
    """Per-tx event key (reference `types/events.go:19` EventStringTx)."""
    return f"Tx:{tx_hash.hex()}"


class EventSwitch:
    """Thread-safe pub/sub keyed by event string
    (tmlibs/events semantics: one callback per (subscriber, event))."""

    def __init__(self):
        self._lock = threading.Lock()
        self._subs: dict[str, dict[str, Callable]] = defaultdict(dict)

    def subscribe(self, subscriber: str, event: str,
                  cb: Callable[[object], None]) -> None:
        with self._lock:
            self._subs[event][subscriber] = cb

    def unsubscribe(self, subscriber: str, event: str) -> None:
        with self._lock:
            self._subs.get(event, {}).pop(subscriber, None)

    def unsubscribe_all(self, subscriber: str) -> None:
        with self._lock:
            for subs in self._subs.values():
                subs.pop(subscriber, None)

    def fire(self, event: str, data: object = None) -> None:
        with self._lock:
            cbs = list(self._subs.get(event, {}).values())
        for cb in cbs:
            cb(data)


class EventCache:
    """Buffers fires until flush (reference `types/events.go:175-177`):
    consensus caches events raised during finalizeCommit and flushes them
    after the new state is committed."""

    def __init__(self, evsw: EventSwitch):
        self._evsw = evsw
        self._pending: list[tuple[str, object]] = []

    def fire(self, event: str, data: object = None) -> None:
        self._pending.append((event, data))

    def flush(self) -> None:
        pending, self._pending = self._pending, []
        for event, data in pending:
            self._evsw.fire(event, data)
