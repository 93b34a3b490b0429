"""Fault-injection connection wrapper for lossy-network tests.

Reference: `p2p/fuzz.go:10-60` — FuzzedConnection randomly drops or
delays reads/writes.  Wraps any conn exposing read_exact/write/close.

Copy of `tendermint_tpu/p2p/fuzz.py`.  Dropping a *write* silently
discards a whole MConnection packet; the framing layer tolerates this
the same way it tolerates a lossy network — messages straddling the gap
fail reassembly and the peer is dropped, or (for idempotent gossip) the
protocol retransmits.  Delay injects jitter.

Reads can never discard bytes (that would desync the framing walk), so
a read selected for "drop" STALLS for `read_stall` seconds instead —
the inbound analog of a dead link whose packets arrive only after
retransmission.  Read and write directions carry independent drop/delay
probabilities, so a scenario can sever one direction of a connection
while the other keeps flowing (one-directional partitions).

Determinism: every decision comes from one RNG seeded with `seed`, which
the caller passes.  The switch seeds its i-th link with
`derive_seed(chaos_seed, "p2p.fuzz", str(i))` from its own link counter
and the chaos seed its owner gave it (`p2p/switch.py`); the JAX package
takes the seed from its installed chaos config and a process-wide
counter.  `seed` is required, so `random.Random(None)` is never reached.
"""

from __future__ import annotations

import random
import threading
import time
import weakref

from tendermint_tpu_torch.utils import chaos as chaosmod

_live: "weakref.WeakSet[FuzzedConnection]" = weakref.WeakSet()

# mutable probability fields set_profile() may touch at runtime
_PROFILE_FIELDS = ("write_drop_prob", "write_delay_prob",
                   "read_drop_prob", "read_delay_prob",
                   "max_delay", "read_stall", "write_garbage_prob")


def live_connections() -> "list[FuzzedConnection]":
    """Every FuzzedConnection currently alive in the process (weakly
    held): the scenario engine's handle for partition/storm injectors
    that flip profiles on connections the switch created internally."""
    return list(_live)


def derived_seed(index: int, seed: int) -> int:
    """Seed for the `index`-th connection under the master `seed`."""
    return chaosmod.derive_seed(seed, "p2p.fuzz", str(index))


class FuzzedConnection:
    def __init__(self, conn, drop_prob: float = 0.0,
                 delay_prob: float = 0.0, max_delay: float = 0.05, *,
                 seed: int,
                 read_drop_prob: float | None = None,
                 read_delay_prob: float | None = None,
                 write_drop_prob: float | None = None,
                 write_delay_prob: float | None = None,
                 read_stall: float | None = None):
        self._conn = conn
        self.max_delay = max_delay
        # two-knob form: drop applies to writes only (reads never drop
        # bytes), delay applies to both directions, unless a
        # per-direction override is given
        self.write_drop_prob = (drop_prob if write_drop_prob is None
                                else write_drop_prob)
        self.write_delay_prob = (delay_prob if write_delay_prob is None
                                 else write_delay_prob)
        self.read_drop_prob = 0.0 if read_drop_prob is None else read_drop_prob
        self.read_delay_prob = (delay_prob if read_delay_prob is None
                                else read_delay_prob)
        self.read_stall = (max_delay * 25 if read_stall is None
                           else read_stall)
        # corrupting-link mode: a selected write has one byte flipped.
        # Below SecretConnection the peer sees a MAC failure, so garbage
        # surfaces as a ValueError conn death — the signal the switch's
        # misbehavior scoring classifies as transport garbage (vs a
        # clean OSError disconnect, which is never scored)
        self.write_garbage_prob = 0.0
        self.seed = seed
        self._rng = random.Random(self.seed)
        self._lock = threading.Lock()
        _live.add(self)

    # -- write-direction aliases ----------------------------------------
    @property
    def drop_prob(self) -> float:
        return self.write_drop_prob

    @drop_prob.setter
    def drop_prob(self, v: float) -> None:
        self.write_drop_prob = v

    @property
    def delay_prob(self) -> float:
        return self.write_delay_prob

    @delay_prob.setter
    def delay_prob(self, v: float) -> None:
        self.write_delay_prob = v

    # -- runtime profile mutation ---------------------------------------
    def set_profile(self, **kw: float) -> None:
        """Atomically update fault probabilities (scenario partitions
        start and heal by flipping these).  Unknown keys raise — a typo'd
        profile silently injecting nothing would fake a passing run."""
        bad = set(kw) - set(_PROFILE_FIELDS)
        if bad:
            raise ValueError(f"unknown fuzz profile fields {sorted(bad)}; "
                             f"known: {_PROFILE_FIELDS}")
        with self._lock:
            for k, v in kw.items():
                setattr(self, k, float(v))

    # -- fuzz decisions -------------------------------------------------
    def _decide(self, drop_p: float, delay_p: float) -> tuple[bool, float]:
        """One RNG draw decides drop-then-delay, under the lock so
        concurrent reader/writer threads interleave on a single stream."""
        with self._lock:
            r = self._rng.random()
            if r < drop_p:
                return True, 0.0
            if r < drop_p + delay_p:
                return False, self._rng.random() * self.max_delay
            return False, 0.0

    def write(self, data: bytes) -> None:
        drop, delay = self._decide(self.write_drop_prob,
                                   self.write_delay_prob)
        if drop:
            return                      # dropped on the floor
        if delay:
            time.sleep(delay)
        if self.write_garbage_prob > 0.0 and data:
            with self._lock:
                if self._rng.random() < self.write_garbage_prob:
                    i = self._rng.randrange(len(data))
                    data = data[:i] + bytes([data[i] ^ 0xFF]) + data[i + 1:]
        self._conn.write(data)

    def read_exact(self, n: int) -> bytes:
        drop, delay = self._decide(self.read_drop_prob,
                                   self.read_delay_prob)
        if drop:
            # bytes can't be discarded without desyncing framing: a
            # "dropped" read stalls instead, severing this direction
            time.sleep(self.read_stall)
        elif delay:
            time.sleep(delay)
        return self._conn.read_exact(n)

    def close(self) -> None:
        self._conn.close()

    @property
    def closed(self) -> bool:
        return self._conn.closed

    @property
    def label(self) -> str:
        return getattr(self._conn, "label", "")
