"""Runtime lock-order witness: catch lock inversions when they happen.

The static checker (`analysis/locks.py`) sees the lock-acquisition
graph the source admits; this module sees the one the running process
actually walks.  While the witness is enabled, ``new_lock(name)``
returns a :class:`WitnessLock` that records, per thread, the stack of
witness locks currently held, and folds every (held -> acquiring) pair
into a process-global order graph.  The first acquisition that
contradicts an edge already in the graph — lock B taken under A
somewhere, A now being taken under B — raises :class:`LockOrderError`
at the acquisition site, naming both orders.  That converts a
once-a-week deadlock hang into a deterministic traceback in whichever
test first exercises both orders, without needing the two threads to
actually race.

Copy of `tendermint_tpu/utils/lockwitness.py` with an explicit switch in
place of the environment: the witness is on for the locks built between
``enable()`` and ``disable()`` (or inside ``with witnessing():``), and
``TM_LOCK_WITNESS`` is not read.  A lock keeps the kind it was built
with.  Outside that window ``new_lock`` returns a plain
``threading.Lock``/``RLock`` — zero overhead.  Every inversion raised
is also kept (``inversions()``), so a run whose threads catch the error
can still be failed on it.

Modeled on Go's lock-order witness in btcd/go-ethereum test builds and
the FreeBSD ``WITNESS(4)`` kernel option.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager


class LockOrderError(RuntimeError):
    """Two witness locks were taken in contradicting orders."""


# process-global order graph: edge (a, b) means "b was acquired while a
# was held", tagged with the thread name that first recorded it.  The
# graph only ever grows; reset() exists for tests.
_graph_mtx = threading.Lock()
_edges: dict[tuple[str, str], str] = {}
_inversions: list[str] = []
_tls = threading.local()
_enabled = False


def enable() -> None:
    """Locks built from now on are witness locks."""
    global _enabled
    _enabled = True


def disable() -> None:
    """Locks built from now on are plain locks (those already built keep
    witnessing)."""
    global _enabled
    _enabled = False


def enabled() -> bool:
    return _enabled


@contextmanager
def witnessing():
    """Witness the locks built inside the block; restores the switch."""
    was = _enabled
    enable()
    try:
        yield
    finally:
        if not was:
            disable()


def reset() -> None:
    """Drop all recorded edges and inversions (test isolation)."""
    with _graph_mtx:
        _edges.clear()
        _inversions.clear()


def edges() -> dict[tuple[str, str], str]:
    """Snapshot of the recorded order graph (for tests/diagnostics)."""
    with _graph_mtx:
        return dict(_edges)


def inversions() -> list[str]:
    """The messages of every LockOrderError raised since the last reset."""
    with _graph_mtx:
        return list(_inversions)


def _held_stack() -> list:
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    return stack


class WitnessLock:
    """A named lock that participates in the global order graph.

    Mirrors the threading lock surface the codebase uses: acquire /
    release / context manager / locked().  Reentrant re-acquisition of
    the same witness lock records no edge (an RLock held twice is one
    node, not a cycle).
    """

    def __init__(self, name: str, reentrant: bool = True):
        self.name = name
        self._inner = (threading.RLock() if reentrant
                       else threading.Lock())

    def _check_order(self) -> None:
        stack = _held_stack()
        if not stack:
            return
        tname = threading.current_thread().name
        with _graph_mtx:
            for held in stack:
                if held.name == self.name:
                    continue            # reentrant: same node
                fwd = (held.name, self.name)
                rev = (self.name, held.name)
                if rev in _edges:
                    msg = (f"lock order inversion: acquiring "
                           f"'{self.name}' while holding '{held.name}' "
                           f"(thread {tname!r}), but thread "
                           f"{_edges[rev]!r} previously acquired "
                           f"'{held.name}' while holding '{self.name}'")
                    _inversions.append(msg)
                    raise LockOrderError(msg)
                _edges.setdefault(fwd, tname)

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        self._check_order()
        got = self._inner.acquire(blocking, timeout)
        if got:
            _held_stack().append(self)
        return got

    def release(self) -> None:
        self._inner.release()
        stack = _held_stack()
        # remove the most recent entry for this lock (locks are almost
        # always released LIFO, but .acquire()/.release() pairs in the
        # codebase occasionally interleave)
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] is self:
                del stack[i]
                break

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def locked(self) -> bool:
        # Lock has .locked(); RLock doesn't expose one portably
        inner_locked = getattr(self._inner, "locked", None)
        return inner_locked() if inner_locked else any(
            l is self for l in _held_stack())

    def __repr__(self):
        return f"WitnessLock({self.name!r})"


def new_lock(name: str, reentrant: bool = True):
    """A lock for `name`: a WitnessLock while the witness is enabled, else
    a plain threading lock.  `name` should be stable across instances of
    the same class ('consensus.mtx', 'mempool.lock') so the order graph
    aggregates by ROLE — an inversion between any consensus lock and
    any mempool lock is the bug, whichever instances exhibit it."""
    if _enabled:
        return WitnessLock(name, reentrant=reentrant)
    return threading.RLock() if reentrant else threading.Lock()
