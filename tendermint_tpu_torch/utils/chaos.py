"""Deterministic device-fault injection for the crypto hot path.

Copy of `tendermint_tpu/utils/chaos.py`.  A `CryptoChaos` is one failure
mode the supervised crypto ladder (`crypto/supervised.py`) injects into
its device rungs, so its fallback and breaker behaviour is testable on a
healthy card.

Spec grammar (one mode, comma-separated k=v params):

    raise:every=N        raise a DeviceFault on every Nth device call
    latency:ms=X,every=N sleep X ms before every Nth call (exercises the
                         per-call timeout)
    wrong:lanes=K,every=N  flip the first K result lanes of every Nth
                         call (exercises the spot-check re-verification)

`every` defaults to 1 (every call).  The schedule is a pure function of
the call counter, so a given spec produces the identical fault sequence
on every run — lossy-device regressions replay exactly, the same promise
`FuzzedConnection(seed=...)` makes for lossy networks.

`ChaosConfig` is the one validated chaos configuration: a master seed
from which every injector derives its RNG (`derive_seed`), and the
crypto spec.  It is an object its owner hands to what it builds (the
scenario engine puts one on `ScenarioContext.chaos`; the ladder takes
`chaos=`; a switch takes `chaos_seed=`).  There is no process-wide
installed config and no environment variable: nothing is read from
`TM_CHAOS_CRYPTO` or `TM_CHAOS_SEED`.
"""

from __future__ import annotations

import hashlib
import threading
import time


class DeviceFault(RuntimeError):
    """An infrastructure failure in a crypto backend: a kernel or runtime
    error, OOM, timeout, hang, or a wrong-answer spot-check mismatch.
    NEVER a statement about signature validity — callers must retry/fall
    back, not report "bad signature" or punish peers.  Its base makes it
    a fault of this node for `p2p.connection.is_node_fault`: the peer
    that sent the message is neither dropped nor blamed."""


class CryptoChaos:
    """One parsed crypto-chaos policy with a deterministic call counter.
    `before_call` runs the raise/latency modes; `corrupt` applies the
    wrong-answer mode to a bool result array."""

    MODES = ("raise", "latency", "wrong")

    def __init__(self, mode: str, every: int = 1, ms: float = 0.0,
                 lanes: int = 1):
        if mode not in self.MODES:
            raise ValueError(f"unknown chaos mode {mode!r}; "
                             f"known: {self.MODES}")
        if every < 1:
            raise ValueError("chaos every= must be >= 1")
        self.mode = mode
        self.every = every
        self.ms = ms
        self.lanes = lanes
        self.active = True          # tests flip this to "clear" injection
        self._count = 0
        self._lock = threading.Lock()

    @classmethod
    def parse(cls, spec: str) -> "CryptoChaos":
        """Parse ``mode:key=val,key=val``.  Raises ValueError on junk —
        a typo'd chaos spec silently injecting nothing would make a
        passing chaos test meaningless."""
        mode, _, rest = spec.partition(":")
        kw: dict = {}
        for part in filter(None, (p.strip() for p in rest.split(","))):
            k, eq, v = part.partition("=")
            if not eq:
                raise ValueError(f"chaos param {part!r} is not k=v")
            if k == "every":
                kw["every"] = int(v)
            elif k == "ms":
                kw["ms"] = float(v)
            elif k == "lanes":
                kw["lanes"] = int(v)
            else:
                raise ValueError(f"unknown chaos param {k!r} in {spec!r}")
        return cls(mode.strip(), **kw)

    def _fire(self) -> bool:
        """Advance the counter; True when this call is selected."""
        if not self.active:
            return False
        with self._lock:
            self._count += 1
            return self._count % self.every == 0

    @property
    def calls(self) -> int:
        return self._count

    def before_call(self) -> None:
        """Raise/latency injection, run where a real device error would
        surface (inside the supervised device-rung invocation)."""
        if self.mode == "wrong":
            return                   # handled after the call, in corrupt()
        if not self._fire():
            return
        if self.mode == "raise":
            raise DeviceFault(
                f"chaos: injected device fault (call {self._count})")
        time.sleep(self.ms / 1000.0)

    def corrupt(self, out):
        """Wrong-answer mode: flip the first `lanes` lanes of a bool
        result — the failure shape of a silently corrupting device, which
        only a reference spot check can catch."""
        if self.mode != "wrong" or not self._fire():
            return out
        import numpy as np
        out = np.array(out, dtype=bool, copy=True)
        k = min(self.lanes, len(out))
        out[:k] = ~out[:k]
        return out


def derive_seed(seed: int, *labels: str) -> int:
    """A child seed for the injector named by `labels`, as a pure
    function of the master seed: sha256 over "seed/label/label/...".
    Independent injectors get decorrelated streams, and the whole tree
    replays from the one integer the scenario was launched with."""
    key = "/".join((str(int(seed)),) + tuple(labels))
    return int.from_bytes(hashlib.sha256(key.encode()).digest()[:8], "big")


class ChaosConfig:
    """The single validated chaos-configuration object.

      seed    master integer seed; every injector RNG (FuzzedConnection,
              byzantine vote schedules, crash schedules, reconnect
              jitter) derives from it via `derive_seed`, so one integer
              replays the whole run
      crypto  device-fault policy for the supervised crypto ladder —
              a CryptoChaos, a spec string ("raise:every=50", validated
              here, at construction), or None for no injection
    """

    def __init__(self, seed: int = 0,
                 crypto: "CryptoChaos | str | None" = None):
        if isinstance(seed, bool) or not isinstance(seed, int):
            raise ValueError(f"chaos seed must be an int, got {seed!r}")
        if isinstance(crypto, str):
            crypto = CryptoChaos.parse(crypto) if crypto else None
        if crypto is not None and not isinstance(crypto, CryptoChaos):
            raise ValueError("chaos crypto= must be a CryptoChaos, a "
                             f"spec string, or None; got {crypto!r}")
        self.seed = seed
        self.crypto = crypto

    def derive_seed(self, *labels: str) -> int:
        return derive_seed(self.seed, *labels)
