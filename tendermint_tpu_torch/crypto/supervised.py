"""SupervisedBackend: runtime fault tolerance for the crypto ladder.

Copy of `tendermint_tpu/crypto/supervised.py` for the port.  The ladder
is cuda -> native -> python: the CUDA kernels on the card, the port's C++
ed25519 on the host (`crypto.native`), and the golden bigint floor
(`crypto.pure_ed25519`).  Every rung answers the same Backend protocol.
The supervisor keeps the JAX package's mechanics:

  * per-call TIMEOUTS on device rungs (a hung call must not wedge the
    consensus thread forever), on a worker pool,
  * bounded RETRY on a device rung before a call falls down the ladder,
  * a CIRCUIT BREAKER per rung: K consecutive faults trip it OPEN (calls
    skip the rung), a cooldown later it goes HALF-OPEN and admits one
    probe; a successful probe restores the rung (CLOSED),
  * optional SPOT CHECKS: every Nth device verify re-checks one sampled
    lane on the golden reference — a silently corrupting device is
    demoted to a fault instead of poisoning consensus,
  * the asynchronous route of the pipelined fast-sync, and
    `supervisor_status` for the node's RPC `status`.

The port's rules change three things.  The ladder is only ever built by
its caller (the node builds it when `crypto.supervised` is set), and
`build()` raises when a rung fails to construct (the JAX `build()` skips
it with a warning): `build("cuda")` without a card raises rather than
serving from the native rung.  Fault injection is explicit: the ladder
takes a `CryptoChaos` (`utils/chaos.py`) as `chaos=`, default None for
none, and injects it into its non-floor rungs (`before_call` before the
rung's call, `corrupt` after it) as the JAX ladder does; nothing is
read from `TM_CHAOS_CRYPTO` or an installed chaos config, and there are
no `TM_CRYPTO_*` environment knobs (the knobs are constructor arguments
with the JAX defaults).  The node passes no chaos; the scenario engine
does.  Every demotion is counted twice: in the rung counters that
`supervisor_status` reports, and in the JAX package's `crypto_*`
metrics (the rung label `cuda` where the JAX package writes `tpu`),
with a `crypto.call` span (no category: the backend's own spans inside
it carry them).  `precompile_for_validators` warms the first rung that
has it and raises its fault (the JAX ladder logs it and goes on): a
warm-up that failed on the card is a card fault, not a cold start.

THE INVARIANT: an infrastructure error is never reported as "bad
signature".  Every verify returns the reference answer (computed on a
lower rung if need be).  `DeviceFault` (defined in `utils/chaos.py`,
re-exported here) leaves the ladder only when its floor raises one
itself, and none of the port's backends does (chaos never reaches the
floor, and a floor's own errors pass unwrapped).  The two callers that
catch it (the mempool's scalar fallback and the light client's one
retry) keep the JAX package's contract: they treat it as retryable —
never as peer misbehavior.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import TimeoutError as FutureTimeout

import numpy as np

from tendermint_tpu_torch.crypto import pure_ed25519 as _ref
from tendermint_tpu_torch.utils import tracing
from tendermint_tpu_torch.utils.chaos import CryptoChaos, DeviceFault
from tendermint_tpu_torch.utils.log import get_logger
from tendermint_tpu_torch.utils.metrics import REGISTRY

log = get_logger("crypto")

# breaker states
CLOSED, HALF_OPEN, OPEN = "closed", "half-open", "open"

# ladder order: fastest rung first, golden reference floor last
LADDER_ORDER = ("cuda", "native", "python")


class _Rung:
    """One ladder rung plus its breaker state (guarded by the
    supervisor's lock)."""

    def __init__(self, name: str, backend, is_device: bool):
        self.name = name
        self.backend = backend
        self.is_device = is_device
        self.state = CLOSED
        self.consecutive_faults = 0
        self.opened_at = 0.0
        self.trips = 0
        self.recoveries = 0
        self.faults = 0
        self.calls = 0
        self._lat_sum = 0.0
        self._lat_n = 0

    def observe(self, seconds: float) -> None:
        self._lat_sum += seconds
        self._lat_n += 1

    def snapshot(self) -> dict:
        mean = self._lat_sum / self._lat_n if self._lat_n else 0.0
        return {"name": self.name, "state": self.state,
                "calls": self.calls, "faults": self.faults,
                "consecutive_faults": self.consecutive_faults,
                "trips": self.trips, "recoveries": self.recoveries,
                "latency_mean_s": round(mean, 6)}


def make_rung(name: str, table_cache_dir: str | None = None):
    """The backend of a ladder rung by name: "cuda" the kernels on the card
    (raises without one), "cpu" their plain PyTorch versions, "native" the
    C++ host rung, "python" the golden floor.  `table_cache_dir` is the
    kernel rungs' on-disk comb-table cache (None: off)."""
    from tendermint_tpu_torch.crypto.backend import CudaBackend, PythonBackend
    from tendermint_tpu_torch.crypto.native import NativeBackend
    if name == "cuda":
        return CudaBackend(table_cache_dir=table_cache_dir)
    if name == "cpu":
        return CudaBackend(device="cpu", table_cache_dir=table_cache_dir)
    if name == "native":
        return NativeBackend()
    if name == "python":
        return PythonBackend()
    raise ValueError(f"unknown crypto rung {name!r}")


class SupervisedBackend:
    """Fronts a ladder of Backend rungs with retry, timeout, breaker, and
    spot-check supervision.  Same Backend protocol as the rungs, so
    consensus/fast-sync/light cannot tell it apart from a bare backend."""

    name = "supervised"

    def __init__(self, rungs: list[tuple[str, object]],
                 breaker_threshold: int = 3,
                 breaker_cooldown_s: float = 30.0,
                 call_timeout_s: float = 60.0,
                 retries: int = 1,
                 spot_check_every: int = 0,
                 chaos: CryptoChaos | None = None):
        if not rungs:
            raise ValueError("supervised backend needs at least one rung")
        # only non-floor rungs are supervised as "devices": the last rung
        # is the trusted floor — no timeout thread, no chaos, and its
        # exceptions (structural errors like set_key misuse) propagate
        self._rungs = [_Rung(n, b, i < len(rungs) - 1)
                       for i, (n, b) in enumerate(rungs)]
        self.breaker_threshold = max(1, breaker_threshold)
        self.breaker_cooldown_s = breaker_cooldown_s
        self.call_timeout_s = call_timeout_s
        self.retries = max(0, retries)
        self.spot_check_every = max(0, spot_check_every)
        # injected device faults (None: none); see utils/chaos.py
        self.chaos = chaos
        self._lock = threading.Lock()
        self._spot_count = 0
        # timeout enforcement: the rung call runs on a worker and we wait
        # with a deadline; a truly hung device call leaks its worker (it
        # cannot be cancelled) so the pool must tolerate a few zombies
        self._pool = ThreadPoolExecutor(
            max_workers=8, thread_name_prefix="crypto-supervisor")

    # -- ladder construction -------------------------------------------
    @classmethod
    def build(cls, primary: str = "cuda", table_cache_dir: str | None = None,
              **knobs) -> "SupervisedBackend":
        """Construct the standard ladder starting at `primary` and ending
        on the python floor (a primary outside LADDER_ORDER gives
        (primary, "python")).  A rung that fails to construct raises."""
        names = (LADDER_ORDER[LADDER_ORDER.index(primary):]
                 if primary in LADDER_ORDER else (primary, "python"))
        return cls([(n, make_rung(n, table_cache_dir)) for n in names],
                   **knobs)

    @property
    def leaf_hashes(self):
        """The first rung's batched leaf hasher: chunk and part-set hashing
        run on it directly, outside the ladder.  AttributeError when that
        rung has none, as on a bare backend without it."""
        return getattr(self._rungs[0].backend, "leaf_hashes")

    # -- breaker mechanics ---------------------------------------------
    def _admit(self, rung: _Rung) -> bool:
        """May a call use this rung right now?  OPEN rungs past their
        cooldown transition to HALF_OPEN and admit the caller as the
        probe."""
        if not rung.is_device:
            return True                      # the floor is always admitted
        with self._lock:
            if rung.state == CLOSED or rung.state == HALF_OPEN:
                return True
            if time.monotonic() - rung.opened_at >= self.breaker_cooldown_s:
                rung.state = HALF_OPEN
                log.info("crypto breaker half-open; probing rung",
                         rung=rung.name)
                return True
            return False

    def _on_fault(self, rung: _Rung, err: BaseException) -> None:
        with self._lock:
            rung.faults += 1
            rung.consecutive_faults += 1
            REGISTRY.crypto_device_faults.inc()
            REGISTRY.crypto_rung_faults.labels(rung.name).inc()
            tripped = False
            if rung.state == HALF_OPEN:
                # failed probe: straight back to OPEN, fresh cooldown
                rung.state = OPEN
                rung.opened_at = time.monotonic()
                rung.trips += 1
                tripped = True
            elif (rung.state == CLOSED and
                    rung.consecutive_faults >= self.breaker_threshold):
                rung.state = OPEN
                rung.opened_at = time.monotonic()
                rung.trips += 1
                tripped = True
            if tripped:
                REGISTRY.crypto_breaker_trips.inc()
        if tripped:
            log.warn("crypto breaker tripped", rung=rung.name,
                     fault=str(err)[:200],
                     consecutive=rung.consecutive_faults)
        else:
            log.warn("crypto device fault", rung=rung.name,
                     fault=str(err)[:200])

    def _on_success(self, rung: _Rung) -> None:
        with self._lock:
            if rung.state == HALF_OPEN:
                rung.state = CLOSED
                rung.recoveries += 1
                REGISTRY.crypto_breaker_recoveries.inc()
                log.info("crypto breaker recovered; rung restored",
                         rung=rung.name)
            rung.consecutive_faults = 0

    # -- invocation -----------------------------------------------------
    def _invoke(self, rung: _Rung, method: str, args: tuple):
        """One attempt on one rung: chaos injection, timeout enforcement,
        latency accounting.  Any exception or timeout from a device rung
        is normalized to DeviceFault; floor-rung exceptions propagate
        (they are caller bugs, not infrastructure)."""
        fn = _rung_fn(rung.backend, method)
        chaos = self.chaos if rung.is_device else None

        def run():
            if chaos is not None:
                chaos.before_call()
            out = fn(*args)
            if chaos is not None:
                out = chaos.corrupt(out)
            return out

        t0 = time.perf_counter()
        rung.calls += 1
        REGISTRY.crypto_rung_calls.labels(rung.name).inc()
        # CAT_NONE: the supervised wrapper's wall clock double-counts the
        # categorized spans the backend emits inside it
        with tracing.span("crypto.call", cat=tracing.CAT_NONE,
                          rung=rung.name, method=method):
            if not rung.is_device:
                out = run()
            else:
                try:
                    if self.call_timeout_s > 0:
                        fut = self._pool.submit(run)
                        try:
                            out = fut.result(timeout=self.call_timeout_s)
                        except FutureTimeout:
                            fut.cancel()
                            raise DeviceFault(
                                f"{rung.name}.{method} exceeded the "
                                f"{self.call_timeout_s}s call timeout")
                    else:
                        out = run()
                except DeviceFault:
                    raise
                except Exception as e:
                    raise DeviceFault(
                        f"{rung.name}.{method} failed: {e!r}") from e
        rung.observe(time.perf_counter() - t0)
        return out

    def _supervised(self, method: str, args: tuple, spot=None):
        """Run `method` down the ladder.  `spot` maps a lane to its (pub,
        msg, sig) bytes for spot-check re-verification of one sampled lane
        on the golden reference."""
        last_fault: BaseException | None = None
        for ri, rung in enumerate(self._rungs):
            if not self._admit(rung):
                continue
            if ri > 0:
                REGISTRY.crypto_fallback_calls.inc()
            attempts = 1 + (self.retries if rung.is_device else 0)
            for _ in range(attempts):
                try:
                    out = self._invoke(rung, method, args)
                    if (spot is not None and rung.is_device and
                            not self._spot_ok(out, spot)):
                        raise DeviceFault(
                            f"{rung.name}.{method} spot check mismatch: "
                            "device answer contradicts the reference")
                    self._on_success(rung)
                    return out
                except DeviceFault as e:
                    last_fault = e
                    self._on_fault(rung, e)
                    with self._lock:
                        open_now = rung.state == OPEN
                    if open_now:
                        break                # tripped: stop retrying here
        # reached only when the floor raised DeviceFault itself
        raise DeviceFault(
            f"all crypto rungs failed for {method}: {last_fault}")

    def _spot_ok(self, out, spot) -> bool:
        """Every Nth device verify re-checks one deterministic lane on
        the bigint reference.  True = consistent (or checking disabled)."""
        if self.spot_check_every <= 0:
            return True
        n = len(out)
        if n == 0:
            return True
        with self._lock:
            self._spot_count += 1
            if self._spot_count % self.spot_check_every != 0:
                return True
            lane = self._spot_count % n
        REGISTRY.crypto_spot_checks.inc()
        pub, msg, sig = spot(lane)
        if bool(out[lane]) == _ref.verify(bytes(pub), bytes(msg),
                                          bytes(sig)):
            return True
        REGISTRY.crypto_spot_check_mismatches.inc()
        return False

    # -- Backend protocol ----------------------------------------------
    def verify_batch(self, pubkeys, msgs, sigs) -> np.ndarray:
        return self._supervised(
            "verify_batch", (pubkeys, msgs, sigs),
            spot=lambda i: (np.asarray(pubkeys)[i].tobytes(),
                            np.asarray(msgs)[i].tobytes(),
                            np.asarray(sigs)[i].tobytes()))

    def verify_grouped(self, set_key, val_pubs, val_idx, msgs,
                       sigs) -> np.ndarray:
        return self._supervised(
            "verify_grouped", (set_key, val_pubs, val_idx, msgs, sigs),
            spot=lambda i: (
                np.asarray(val_pubs)[int(np.asarray(val_idx)[i])].tobytes(),
                np.asarray(msgs)[i].tobytes(),
                np.asarray(sigs)[i].tobytes()))

    def verify_grouped_templated(self, set_key, val_pubs, val_idx,
                                 tmpl_idx, templates, sigs) -> np.ndarray:
        return self._supervised(
            "verify_grouped_templated",
            (set_key, val_pubs, val_idx, tmpl_idx, templates, sigs),
            spot=lambda i: (
                np.asarray(val_pubs)[int(np.asarray(val_idx)[i])].tobytes(),
                np.asarray(templates)[
                    int(np.asarray(tmpl_idx)[i])].tobytes(),
                np.asarray(sigs)[i].tobytes()))

    def verify_grouped_templated_async(self, set_key, val_pubs, val_idx,
                                       tmpl_idx, templates, sigs,
                                       real_n: int | None = None):
        """Async dispatch rides the active rung when it supports it; a
        fault at dispatch OR collect re-verifies the batch synchronously
        down the ladder — pipelined callers see a slow window, never an
        exception or a wrong answer."""
        def sync_fallback() -> np.ndarray:
            vi = np.asarray(val_idx)
            ti = np.asarray(tmpl_idx)
            sg = np.asarray(sigs)
            n = real_n if real_n is not None else len(vi)
            return self.verify_grouped_templated(
                set_key, np.asarray(val_pubs), vi[:n], ti[:n],
                np.asarray(templates), sg[:n])

        rung = self._active_rung()
        fn = getattr(rung.backend, "verify_grouped_templated_async", None) \
            if rung is not None else None
        if fn is None:
            out = sync_fallback()
            return lambda: out
        try:
            collect = self._invoke_async_dispatch(rung, fn, (
                set_key, val_pubs, val_idx, tmpl_idx, templates, sigs),
                real_n)
        except DeviceFault as e:
            self._on_fault(rung, e)
            out = sync_fallback()
            return lambda: out

        def supervised_collect() -> np.ndarray:
            try:
                out = collect()
            except Exception as e:
                fault = e if isinstance(e, DeviceFault) else DeviceFault(
                    f"{rung.name}.collect failed: {e!r}")
                self._on_fault(rung, fault)
                return sync_fallback()
            self._on_success(rung)
            return out

        return supervised_collect

    def _invoke_async_dispatch(self, rung: _Rung, fn, args, real_n):
        """Dispatch half of the async path (can block on table builds, so
        it gets the same timeout + fault normalization as a sync call)."""
        chaos = self.chaos if rung.is_device else None

        def run():
            if chaos is not None:
                chaos.before_call()
            collect = fn(*args, real_n=real_n)
            if chaos is not None:
                inner = collect
                return lambda: chaos.corrupt(inner())
            return collect

        rung.calls += 1
        REGISTRY.crypto_rung_calls.labels(rung.name).inc()
        try:
            if self.call_timeout_s > 0 and rung.is_device:
                fut = self._pool.submit(run)
                try:
                    return fut.result(timeout=self.call_timeout_s)
                except FutureTimeout:
                    fut.cancel()
                    raise DeviceFault(
                        f"{rung.name}.dispatch exceeded the "
                        f"{self.call_timeout_s}s call timeout")
            return run()
        except DeviceFault:
            raise
        except Exception as e:
            raise DeviceFault(f"{rung.name}.dispatch failed: {e!r}") from e

    def _active_rung(self) -> _Rung | None:
        """First rung the breaker currently admits."""
        for rung in self._rungs:
            if self._admit(rung):
                return rung
        return None

    def active_rung_name(self) -> str | None:
        """Name of the rung the ladder would serve from right now — the
        hook consumers (vote-ingest micro-batching) use to make
        device-vs-scalar decisions through the supervisor without reaching
        into breaker internals."""
        rung = self._active_rung()
        return rung.name if rung is not None else None

    def active_backend(self):
        """The backend of the rung the ladder would serve from right now,
        or None."""
        rung = self._active_rung()
        return rung.backend if rung is not None else None

    # -- passthroughs ---------------------------------------------------
    def precompile_for_validators(self, vals) -> None:
        """Warm the first rung that can be warmed (the device rung; the
        host rungs have nothing to warm).  Its fault is raised, not
        logged: nothing hides the card (ROADMAP C.6)."""
        for rung in self._rungs:
            fn = getattr(rung.backend, "precompile_for_validators", None)
            if fn is not None:
                fn(vals)
                return

    def tables_cached(self, set_key: bytes) -> bool:
        """True when the ACTIVE rung would serve this set without a table
        build: device rungs delegate; CPU rungs need no tables, so a
        tripped-to-CPU ladder reports warm."""
        rung = self._active_rung()
        if rung is None:
            return True
        fn = getattr(rung.backend, "tables_cached", None)
        return True if fn is None else fn(set_key)

    def sign_grouped_templated(self, seeds, val_idx, tmpl_idx,
                               templates) -> np.ndarray:
        """Batch signing rides the device when healthy; the reference
        signs lane-by-lane otherwise (fixture/testnet path — correctness
        over speed)."""
        for rung in self._rungs:
            fn = getattr(rung.backend, "sign_grouped_templated", None)
            if fn is None or not self._admit(rung):
                continue
            try:
                out = self._invoke(rung, "sign_grouped_templated",
                                   (seeds, val_idx, tmpl_idx, templates))
                self._on_success(rung)
                return out
            except DeviceFault as e:
                self._on_fault(rung, e)
        tm = np.asarray(templates)
        out = np.zeros((len(val_idx), 64), dtype=np.uint8)
        for i, (vi, ti) in enumerate(zip(val_idx, tmpl_idx)):
            sig = _ref.sign(bytes(seeds[int(vi)]), tm[int(ti)].tobytes())
            out[i] = np.frombuffer(sig, np.uint8)
        return out

    # -- introspection --------------------------------------------------
    def supervisor_status(self) -> dict:
        """Breaker/ladder state for the RPC status endpoint and tests."""
        with self._lock:
            rungs = [r.snapshot() for r in self._rungs]
        active = self._active_rung()
        return {
            "active_rung": active.name if active is not None else None,
            "breaker_threshold": self.breaker_threshold,
            "breaker_cooldown_s": self.breaker_cooldown_s,
            "call_timeout_s": self.call_timeout_s,
            "retries": self.retries,
            "spot_check_every": self.spot_check_every,
            "chaos": (f"{self.chaos.mode}:every={self.chaos.every}"
                      if self.chaos is not None and self.chaos.active
                      else None),
            "rungs": rungs,
        }


def _rung_fn(backend, method: str):
    """Resolve `method` on a rung, adapting down the protocol (a rung
    without the templated form gathers host-side and batches plainly)."""
    fn = getattr(backend, method, None)
    if fn is not None:
        return fn
    if method == "verify_grouped":
        return lambda set_key, val_pubs, val_idx, msgs, sigs: \
            backend.verify_batch(np.asarray(val_pubs)[np.asarray(val_idx)],
                                 msgs, sigs)
    if method == "verify_grouped_templated":
        inner = _rung_fn(backend, "verify_grouped")
        return lambda set_key, val_pubs, val_idx, tmpl_idx, templates, \
            sigs: inner(set_key, val_pubs, val_idx,
                        np.asarray(templates)[np.asarray(tmpl_idx)], sigs)
    raise AttributeError(f"rung backend {backend!r} lacks {method}")
