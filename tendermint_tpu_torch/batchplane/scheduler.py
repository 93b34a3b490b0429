"""The device batch plane: one verify scheduler for every producer.

Copy of `tendermint_tpu/batchplane/scheduler.py` for the port.  Producers
(consensus votes, fast-sync windows, light-client verifies, mempool
CheckTx) submit signature lanes; one worker thread coalesces them into
batches and runs each batch through the backend the plane was built with.

Scheduling contract:

* **Priority classes.**  Every submission carries a class —
  ``consensus`` > ``fastsync`` > ``mempool`` > ``light`` — and when more
  than one batch is ready to ship, the highest class ships first.
* **Deadline-aware flushing.**  A batch ships when it is FULL (its lane
  count reaches `target_lanes`) or when its oldest submission's deadline
  arrives; full batches ship before due ones.  Each class has a maximum
  queue wait (the reference's defaults, overridable per plane).
* **Per-producer fairness.**  When a flush must truncate (more lanes
  queued than `max_flush_lanes`), lanes are taken round-robin across
  producers; leftovers stay queued at their original deadlines.
* **Fault isolation.**  An error in a flush fails only the submissions of
  that flush: it re-raises in each of their `wait()`s, and queued work
  and later flushes are untouched.

Merging follows the backend's entry points: grouped lanes merge per
validator-set key and message length, templated lanes per set key with
template-index rebasing, raw per-lane ed25519 lanes merge across ALL
producers (the mempool CheckTx lane, kernel K5 on `CudaBackend`), and
secp256k1 lanes coalesce into one host-side pass.

The port drops the reference's process-wide singleton, its
`TM_BATCHPLANE*` environment overrides and inline mode, and its metrics:
the plane is built with an explicit backend and knobs, and an optional
`on_flush(kind, reason, lanes, producers)` callback observes each flush.
"""

from __future__ import annotations

import threading
import time

import numpy as np

# -- priority classes --------------------------------------------------------

CLASS_CONSENSUS = "consensus"
CLASS_FASTSYNC = "fastsync"
CLASS_MEMPOOL = "mempool"
CLASS_LIGHT = "light"

# lower number = higher priority (consensus preempts everything)
CLASS_PRIORITY = {CLASS_CONSENSUS: 0, CLASS_FASTSYNC: 1,
                  CLASS_MEMPOOL: 2, CLASS_LIGHT: 3}

# default max queue wait (seconds) before a submission's batch must ship
# even half-empty: votes are on the live-round critical path, fast-sync
# windows arrive in bulk and can afford to coalesce longer
DEFAULT_WAIT = {CLASS_CONSENSUS: 0.002, CLASS_FASTSYNC: 0.02,
                CLASS_MEMPOOL: 0.010, CLASS_LIGHT: 0.025}


class Submission:
    """One producer's slice of a future device batch.  `wait()` blocks
    until the worker flushed the batch and returns this slice's bool
    lanes — or re-raises the flush's error."""

    __slots__ = ("kind", "key", "producer", "klass", "deadline", "enq_t",
                 "arrays", "n", "_event", "_result", "_error")

    def __init__(self, kind, key, producer, klass, deadline, arrays, n):
        self.kind = kind
        self.key = key
        self.producer = producer
        self.klass = klass
        self.deadline = deadline
        self.enq_t = time.perf_counter()
        self.arrays = arrays
        self.n = n
        self._event = threading.Event()
        self._result = None
        self._error = None

    def _resolve(self, result) -> None:
        self._result = result
        self._event.set()

    def _fail(self, exc: BaseException) -> None:
        self._error = exc
        self._event.set()

    def wait(self) -> np.ndarray:
        self._event.wait()
        if self._error is not None:
            raise self._error
        return self._result


class _PendingBatch:
    """Submissions sharing one merge key, in arrival order."""

    __slots__ = ("key", "subs", "lanes")

    def __init__(self, key):
        self.key = key
        self.subs: list[Submission] = []
        self.lanes = 0

    def add(self, sub: Submission) -> None:
        self.subs.append(sub)
        self.lanes += sub.n

    @property
    def priority(self) -> int:
        return min(CLASS_PRIORITY.get(s.klass, 9) for s in self.subs)

    @property
    def oldest_deadline(self) -> float:
        return min(s.deadline for s in self.subs)


class BatchPlane:
    """The shared scheduler over one backend (`crypto.backend`)."""

    def __init__(self, backend, target_lanes: int = 1024,
                 max_flush_lanes: int = 4096,
                 waits: dict[str, float] | None = None, on_flush=None):
        self.backend = backend
        # a batch is FULL (ships immediately) at target_lanes; one flush
        # never takes more than max_flush_lanes (fairness truncation)
        self.target_lanes = target_lanes
        self.max_flush_lanes = max_flush_lanes
        self.waits = {**DEFAULT_WAIT, **(waits or {})}
        self.on_flush = on_flush
        self._cond = threading.Condition()
        self._pending: dict[tuple, _PendingBatch] = {}
        self._thread: threading.Thread | None = None
        self._stopped = False
        self._inflight = 0          # submissions being executed right now

    # -- submission entry points ----------------------------------------

    def _submit(self, kind, key, producer, klass, arrays, n,
                max_wait: float | None) -> Submission:
        wait_s = self.waits.get(klass, 0.02) if max_wait is None \
            else max_wait
        sub = Submission(kind, key, producer, klass,
                         time.perf_counter() + wait_s, arrays, n)
        with self._cond:
            if self._stopped:
                raise RuntimeError("batch plane is stopped")
            batch = self._pending.get(key)
            if batch is None:
                batch = self._pending[key] = _PendingBatch(key)
            batch.add(sub)
            self._ensure_worker()
            self._cond.notify_all()
        return sub

    def submit_grouped(self, set_key: bytes, val_pubs, val_idx, msgs,
                       sigs, *, producer: str, klass: str,
                       max_wait: float | None = None) -> Submission:
        n = len(val_idx)
        key = ("grouped", bytes(set_key), msgs.shape[-1] if n else 0)
        arrays = (val_pubs, np.asarray(val_idx, np.int32),
                  np.asarray(msgs), np.asarray(sigs))
        return self._submit("grouped", key, producer, klass, arrays, n,
                            max_wait)

    def submit_templated(self, set_key: bytes, val_pubs, val_idx,
                         tmpl_idx, templates, sigs, *, producer: str,
                         klass: str,
                         max_wait: float | None = None) -> Submission:
        n = len(val_idx)
        key = ("templated", bytes(set_key),
               templates.shape[-1] if len(templates) else 0)
        arrays = (val_pubs, np.asarray(val_idx, np.int32),
                  np.asarray(tmpl_idx, np.int32), np.asarray(templates),
                  np.asarray(sigs))
        return self._submit("templated", key, producer, klass, arrays, n,
                            max_wait)

    def submit_raw(self, pubkeys, msgs, sigs, *, producer: str,
                   klass: str, max_wait: float | None = None) -> Submission:
        """Per-lane ed25519 verify (pubkeys NOT from a fixed set): the
        mempool CheckTx lane.  Raw lanes merge across ALL producers."""
        n = len(sigs)
        key = ("raw", msgs.shape[-1] if n else 0)
        arrays = (np.asarray(pubkeys), np.asarray(msgs), np.asarray(sigs))
        return self._submit("raw", key, producer, klass, arrays, n,
                            max_wait)

    def submit_secp(self, items: list[tuple[bytes, bytes, bytes]], *,
                    producer: str, klass: str,
                    max_wait: float | None = None) -> Submission:
        """secp256k1 lanes as (pub33, msg, der_sig) tuples, coalesced into
        one host-side OpenSSL pass."""
        return self._submit("secp", ("secp",), producer, klass,
                            (list(items),), len(items), max_wait)

    # -- synchronous producer wrappers ----------------------------------

    def verify_grouped(self, set_key, val_pubs, val_idx, msgs, sigs, *,
                       producer: str, klass: str,
                       max_wait: float | None = None) -> np.ndarray:
        return self.submit_grouped(set_key, val_pubs, val_idx, msgs, sigs,
                                   producer=producer, klass=klass,
                                   max_wait=max_wait).wait()

    def verify_grouped_templated(self, set_key, val_pubs, val_idx,
                                 tmpl_idx, templates, sigs, *,
                                 producer: str, klass: str,
                                 max_wait: float | None = None
                                 ) -> np.ndarray:
        return self.submit_templated(set_key, val_pubs, val_idx, tmpl_idx,
                                     templates, sigs, producer=producer,
                                     klass=klass, max_wait=max_wait).wait()

    def verify_batch(self, pubkeys, msgs, sigs, *, producer: str,
                     klass: str, max_wait: float | None = None
                     ) -> np.ndarray:
        return self.submit_raw(pubkeys, msgs, sigs, producer=producer,
                               klass=klass, max_wait=max_wait).wait()

    def verify_secp(self, items, *, producer: str, klass: str,
                    max_wait: float | None = None) -> np.ndarray:
        return self.submit_secp(items, producer=producer, klass=klass,
                                max_wait=max_wait).wait()

    # -- worker ---------------------------------------------------------

    def _ensure_worker(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._run, name="batchplane", daemon=True)
            self._thread.start()

    def _run(self) -> None:
        while True:
            with self._cond:
                while not self._pending and not self._stopped:
                    self._cond.wait()
                if self._stopped and not self._pending:
                    return
                batch, reason = self._next_flush_locked()
                if batch is None:
                    # nothing due yet: sleep until the earliest deadline
                    horizon = min(b.oldest_deadline
                                  for b in self._pending.values())
                    self._cond.wait(
                        max(horizon - time.perf_counter(), 1e-4))
                    continue
                subs = self._take_locked(batch)
                self._inflight += len(subs)
            try:
                self._execute(subs, reason)
            finally:
                with self._cond:
                    self._inflight -= len(subs)
                    self._cond.notify_all()

    def _next_flush_locked(self):
        """(batch, reason) to flush now, or (None, None) if nothing is
        full or due.  Full batches beat due batches; among candidates
        the highest class wins, then the oldest deadline."""
        now = time.perf_counter()
        full = [b for b in self._pending.values()
                if b.lanes >= self.target_lanes]
        due = [b for b in self._pending.values()
               if b.oldest_deadline <= now]
        pick = lambda bs: min(              # noqa: E731 (tiny chooser)
            bs, key=lambda b: (b.priority, b.oldest_deadline))
        if full:
            return pick(full), "full"
        if due:
            return pick(due), "deadline"
        return None, None

    def _take_locked(self, batch: _PendingBatch) -> list[Submission]:
        """Remove up to max_flush_lanes from `batch`, round-robin across
        producers so no producer starves out of a truncated flush."""
        if batch.lanes <= self.max_flush_lanes:
            del self._pending[batch.key]
            return batch.subs
        by_producer: dict[str, list[Submission]] = {}
        for s in batch.subs:
            by_producer.setdefault(s.producer, []).append(s)
        taken, lanes = [], 0
        queues = list(by_producer.values())
        while queues and lanes < self.max_flush_lanes:
            for q in list(queues):
                if not q:
                    queues.remove(q)
                    continue
                nxt = q[0]
                if taken and lanes + nxt.n > self.max_flush_lanes:
                    queues.remove(q)      # would overflow; producer done
                    continue
                taken.append(q.pop(0))
                lanes += nxt.n
        left = [s for s in batch.subs if s not in taken]
        if left:
            nb = _PendingBatch(batch.key)
            for s in left:
                nb.add(s)
            self._pending[batch.key] = nb
        else:
            del self._pending[batch.key]
        # keep arrival order within the flush (stable lane slicing)
        taken.sort(key=lambda s: s.enq_t)
        return taken

    # -- execution ------------------------------------------------------

    def _execute(self, subs: list[Submission], reason: str) -> None:
        kind = subs[0].kind
        try:
            if self.on_flush is not None:
                self.on_flush(kind, reason, sum(s.n for s in subs),
                              {s.producer for s in subs})
            if kind == "grouped":
                out = self._run_grouped(subs)
            elif kind == "templated":
                out = self._run_templated(subs)
            elif kind == "raw":
                out = self._run_raw(subs)
            else:
                out = self._run_secp(subs)
        except BaseException as e:                # blame ONLY this flush
            for s in subs:
                s._fail(e)
            return
        off = 0
        for s in subs:
            s._resolve(out[off:off + s.n])
            off += s.n

    def _run_grouped(self, subs) -> np.ndarray:
        set_key = subs[0].key[1]
        val_pubs = subs[0].arrays[0]
        idx = np.concatenate([s.arrays[1] for s in subs])
        msgs = np.concatenate([s.arrays[2] for s in subs])
        sigs = np.concatenate([s.arrays[3] for s in subs])
        return self.backend.verify_grouped(set_key, val_pubs, idx, msgs,
                                           sigs)

    def _run_templated(self, subs) -> np.ndarray:
        set_key = subs[0].key[1]
        val_pubs = subs[0].arrays[0]
        # rebase each submission's template indices onto the combined
        # template block (the merge_commit_lanes layout)
        t_off, tmpl_parts, idx_parts = 0, [], []
        for s in subs:
            _vp, _vi, ti, templates, _sg = s.arrays
            idx_parts.append(ti + t_off)
            tmpl_parts.append(templates)
            t_off += len(templates)
        idx = np.concatenate([s.arrays[1] for s in subs])
        tmpl_idx = np.concatenate(idx_parts)
        templates = np.concatenate(tmpl_parts)
        sigs = np.concatenate([s.arrays[4] for s in subs])
        return self.backend.verify_grouped_templated(
            set_key, val_pubs, idx, tmpl_idx, templates, sigs)

    def _run_raw(self, subs) -> np.ndarray:
        pubs = np.concatenate([s.arrays[0] for s in subs])
        msgs = np.concatenate([s.arrays[1] for s in subs])
        sigs = np.concatenate([s.arrays[2] for s in subs])
        return self.backend.verify_batch(pubs, msgs, sigs)

    @staticmethod
    def _run_secp(subs) -> np.ndarray:
        from tendermint_tpu_torch.crypto import secp256k1
        out = []
        for s in subs:
            for pub, msg, sig in s.arrays[0]:
                out.append(
                    secp256k1.PubKeySecp256k1(pub).verify(msg, sig))
        return np.asarray(out, dtype=bool)

    # -- lifecycle / introspection --------------------------------------

    def drain(self, timeout: float = 30.0) -> bool:
        """Block until the queue AND in-flight work are empty.  True when
        drained, False on timeout."""
        deadline = time.monotonic() + timeout
        with self._cond:
            while self._pending or self._inflight:
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self._cond.notify_all()
                self._cond.wait(min(left, 0.05))
        return True

    def stop(self) -> None:
        with self._cond:
            self._stopped = True
            self._cond.notify_all()
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout=5.0)

    def depth(self) -> int:
        with self._cond:
            return sum(len(b.subs) for b in self._pending.values())

    def class_depth(self, klass: str) -> int:
        """Pending LANES carrying `klass` submissions: the mempool's
        admission backpressure probes this before verifying."""
        with self._cond:
            return sum(s.n for b in self._pending.values()
                       for s in b.subs if s.klass == klass)
