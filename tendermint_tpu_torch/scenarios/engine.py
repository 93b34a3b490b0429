"""Seed-deterministic fault-scenario engine.

A *scenario* is a declarative composition of fault injectors (byzantine
vote streams, network partitions, crash-restart storms, device-fault
storms) plus a post-mortem: safety and liveness invariants checked
against flight-recorder and metric evidence after the run.

The replay contract
-------------------
Every scenario runs from ONE integer seed.  All injector randomness is
derived from it through `utils.chaos.derive_seed(seed, *labels)` — the
per-injector RNGs, the `FuzzedConnection` streams, the crash schedule,
the byzantine height sets.  The engine keeps an *event log* with two
streams:

- **plan events** (`ctx.plan(...)`): the injected-fault schedule as
  derived from the seed — which heights equivocate, which window the
  partition covers, which chaos spec the crypto ladder gets, which RNG
  seeds were handed out.  Plan events are a pure function of
  (scenario, seed): their canonical-JSON sha256 is the *event log
  hash*, and two runs with the same seed MUST produce the same hash
  (tier-1 asserts this).
- **notes** (`ctx.note(...)`): what actually happened at runtime
  (timing-dependent: observed heights, breaker trips, eviction order).
  Notes are dumped for triage but never hashed.

Post-mortem + artifacts
-----------------------
After the scenario body returns, the engine runs its registered safety
and liveness invariants.  On ANY failure (body exception or invariant
violation) it dumps a per-scenario artifact directory:

    <artifacts>/<scenario>-seed<N>/
        trace.json      flight-recorder Chrome trace (load in Perfetto)
        metrics.json    phase-labeled REGISTRY snapshots (incl. per-rung
                        crypto counters)
        events.json     the event log: plan stream, hash, and notes
        result.json     manifest: outcome, failures, seed — the replay
                        input for `cli chaos replay`

Triage flow: read result.json for the failed invariant, open trace.json
in Perfetto against events.json's plan timeline, then re-run bit-
identically with `cli chaos run --scenario <name> --seed <N>` (or
`cli chaos replay --manifest result.json`, which also takes the run's
backend from the manifest).

Copy of `tendermint_tpu/scenarios/engine.py` with the port's rules.
Nothing is installed process-wide: the engine builds the run's crypto
backend (`make_scenario_backend`) and a `ChaosConfig(seed)` and puts
them on `ctx.backend` and `ctx.chaos`; the bodies and rigs pass them on
to what they build (planes, ladders, switches).  The backend names are
the port's (`KNOWN_BACKENDS`), and a run that names none runs on the
card: a scenario declared on "python" runs on "cuda", one declared on
"rig" on "cuda-rig" (`resolve_backend`), and without a card
`CudaBackend()` raises before the body runs.  The event log's lock is
the witness's "scenarios.eventlog" role, no environment variable is
read (`TM_SCENARIO_BACKEND`, `TM_SCENARIO_ARTIFACTS`), and the timeline
and consensus-doctor files of the bundle are written without a `try`
around them.  A crashing body is still a failed scenario with its
bundle, as in the JAX package.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import threading
import time

from tendermint_tpu_torch.utils import chaos as chaosmod
from tendermint_tpu_torch.utils import lockwitness
from tendermint_tpu_torch.utils import tracing
from tendermint_tpu_torch.utils.log import get_logger
from tendermint_tpu_torch.utils.metrics import REGISTRY

log = get_logger("scenarios")

# Fixed default seed for the faults tier: CI runs are reproducible by
# default, and a red run's artifact names tell you the seed to replay.
DEFAULT_SEED = 20260806


class InvariantViolation(AssertionError):
    """A scenario post-mortem assertion failed.  The message must carry
    the evidence (heights, hashes, metric values) — it is what lands in
    result.json for triage."""


class EventLog:
    """Deterministic plan stream + timing-dependent note stream.

    Concurrency: notes may arrive from any injector thread (the lock
    serializes them); plan events may NOT — their ORDER is part of the
    hash, and thread interleaving would make it timing-dependent.  The
    engine seals the plan stream while scheduled injectors run
    concurrently (`sealed_plan`), so a plan() from inside a concurrent
    injector fails loudly instead of silently breaking replay."""

    def __init__(self):
        self._plan: list[dict] = []
        self._notes: list[dict] = []
        self._sealed = False
        self._lock = lockwitness.new_lock("scenarios.eventlog",
                                          reentrant=False)

    def plan(self, event: str, **fields) -> None:
        """Record one planned injection.  Fields must be JSON-safe and
        derived only from the seed (never wall-clock) — they are hashed
        into the determinism contract."""
        with self._lock:
            if self._sealed:
                raise RuntimeError(
                    f"plan event {event!r} emitted while the plan stream "
                    f"is sealed (concurrent injectors are running): plan "
                    f"order would be timing-dependent and break the "
                    f"event_log_hash replay contract — derive the whole "
                    f"schedule before InjectorSchedule.run()")
            self._plan.append({"event": event, **fields})

    def note(self, event: str, **fields) -> None:
        """Record a runtime observation (not hashed)."""
        with self._lock:
            self._notes.append({"t": round(time.time(), 6),
                                "event": event, **fields})

    @contextlib.contextmanager
    def sealed_plan(self):
        """Freeze the plan stream (plan() raises) while concurrent
        injector threads run; notes stay open."""
        with self._lock:
            self._sealed = True
        try:
            yield
        finally:
            with self._lock:
                self._sealed = False

    def hash(self) -> str:
        blob = json.dumps(self._plan, sort_keys=True,
                          separators=(",", ":")).encode()
        return hashlib.sha256(blob).hexdigest()

    def to_dict(self) -> dict:
        return {"hash": self.hash(), "plan": list(self._plan),
                "notes": list(self._notes)}


class ScenarioContext:
    """What a scenario body (and its injectors) gets to work with."""

    def __init__(self, scenario: "Scenario", seed: int):
        self.scenario = scenario
        self.seed = seed
        self.log = EventLog()
        self.recorder = tracing.RECORDER
        self.metric_phases: list[dict] = []
        self._rngs: dict[str, object] = {}
        # the run's crypto backend (run_scenario sets it): rigs build
        # their batch plane over it, bodies drive ladder probes through it
        self.backend = None
        self.backend_name: str | None = None
        # the run's chaos configuration (master seed; rigs derive their
        # fuzz and reconnect seeds from it, ladders take its crypto spec)
        self.chaos = chaosmod.ChaosConfig(seed=seed)

    # -- derived randomness ---------------------------------------------
    def derive_seed(self, *labels: str) -> int:
        return chaosmod.derive_seed(self.seed, self.scenario.name, *labels)

    def rng(self, name: str):
        """A named `random.Random` derived from the scenario seed; the
        derivation is logged as a plan event so the seed handed to each
        injector is part of the hashed schedule."""
        if name not in self._rngs:
            import random
            child = self.derive_seed("rng", name)
            self.log.plan("rng", name=name, seed=child)
            self._rngs[name] = random.Random(child)
        return self._rngs[name]

    # -- event log shorthands -------------------------------------------
    def plan(self, event: str, **fields) -> None:
        self.log.plan(event, **fields)

    def note(self, event: str, **fields) -> None:
        self.log.note(event, **fields)

    # -- evidence capture ------------------------------------------------
    def snapshot_metrics(self, phase: str) -> dict:
        """Capture a phase-labeled REGISTRY snapshot (includes the
        rung-labeled crypto counters) — the metric evidence invariants
        assert against."""
        snap = {"phase": phase, "metrics": REGISTRY.snapshot()}
        self.metric_phases.append(snap)
        self.recorder.instant("scenario.phase", phase=phase)
        return snap

    def metrics(self, phase: str) -> dict | None:
        for snap in self.metric_phases:
            if snap["phase"] == phase:
                return snap["metrics"]
        return None

    # -- composable injector schedules ----------------------------------
    def schedule(self, label: str = "schedule") -> "InjectorSchedule":
        """A combined-adversary schedule: declare several injectors with
        seed-derived phase offsets, then run them CONCURRENTLY."""
        return InjectorSchedule(self, label)


class InjectorSchedule:
    """Multiple injectors running concurrently with seed-derived phase
    offsets, folded into the one event_log_hash replay contract.

    Declaration (`add`) is single-threaded and emits the plan events:
    each entry's offset = `after` + U(0, jitter_s) drawn from the
    scenario seed, so the combined schedule replays bit-identically.
    Execution (`run`) spawns one thread per entry, SEALS the plan stream
    for the duration (injector bodies must have derived their whole
    schedule already — runtime effects record notes only), sleeps each
    entry to its offset, and joins them all.  Injector exceptions are
    collected and re-raised after the join so one broken injector never
    strands the others' threads."""

    def __init__(self, ctx: ScenarioContext, label: str = "schedule"):
        self.ctx = ctx
        self.label = label
        self._entries: list[tuple[str, float, object]] = []

    def add(self, name: str, fn, *, after: float = 0.0,
            jitter_s: float = 0.0) -> float:
        """Declare injector `name` (a zero-arg callable) to fire at
        `after` + seed-derived U(0, jitter_s) seconds into run().
        Returns the planned offset."""
        offset = float(after)
        if jitter_s > 0.0:
            rng = self.ctx.rng(f"{self.label}.{name}")
            offset += rng.random() * float(jitter_s)
        offset = round(offset, 6)
        self.ctx.plan("injector-schedule", schedule=self.label,
                      name=name, offset_s=offset)
        self._entries.append((name, offset, fn))
        return offset

    def run(self, join_timeout_s: float = 120.0) -> None:
        """Fire every declared injector at its offset, concurrently."""
        errors: list[tuple[str, BaseException]] = []
        err_lock = threading.Lock()

        def runner(name: str, offset: float, fn) -> None:
            time.sleep(offset)
            self.ctx.note("injector.fire", schedule=self.label, name=name,
                          offset_s=offset)
            try:
                fn()
            except BaseException as e:  # noqa: BLE001 - surfaced after join
                with err_lock:
                    errors.append((name, e))
                self.ctx.note("injector.error", schedule=self.label,
                              name=name,
                              error=f"{type(e).__name__}: {e}")
            else:
                self.ctx.note("injector.done", schedule=self.label,
                              name=name)

        threads = [threading.Thread(target=runner, args=e, daemon=True,
                                    name=f"injector-{e[0]}")
                   for e in self._entries]
        with self.ctx.log.sealed_plan():
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=join_timeout_s)
        alive = [t.name for t in threads if t.is_alive()]
        if alive:
            raise RuntimeError(
                f"injector schedule {self.label!r} timed out: "
                f"{alive} still running after {join_timeout_s}s")
        if errors:
            name, exc = errors[0]
            raise RuntimeError(
                f"injector {name!r} in schedule {self.label!r} failed: "
                f"{type(exc).__name__}: {exc}") from exc


# -- scenario crypto backends ----------------------------------------------
#
# Rigs are backend-parametric: every scenario declares a default rung
# (python unless it says otherwise), and an explicit
# run_scenario(backend=...) overrides it.  "python" is a bare
# PythonBackend (bit-deterministic CPU smoke tier); "rig" is a two-rung
# supervised ladder whose device-role rung is a PythonBackend — the
# deterministic chaos-capable ladder the big rigs run on the CPU, with
# the same breaker/demotion machinery as the real device ladder.  "cuda"
# is a bare CudaBackend (the kernels on the card), "cuda-rig" the rig
# ladder with a CudaBackend as its "dev" rung, "native" the ladder from
# the C++ host rung down and "ladder" the full cuda -> native -> python
# ladder (`SupervisedBackend.build`).
KNOWN_BACKENDS = ("python", "rig", "cuda", "cuda-rig", "native", "ladder")
DEFAULT_SCENARIO_BACKEND = "python"
# with no backend named, a run goes to the card: the declared CPU rung
# maps to its card twin
CARD_BACKENDS = {"python": "cuda", "rig": "cuda-rig"}
# the names whose device-role rung is a CudaBackend
ON_CARD = ("cuda", "cuda-rig", "ladder")
RIG_KNOBS = dict(breaker_threshold=2, breaker_cooldown_s=0.5,
                 retries=0, call_timeout_s=30.0)


def _check_backend(name: str) -> str:
    if name == "tpu":
        raise ValueError("scenario backend 'tpu' is the JAX package's; "
                         "the port's card backend is 'cuda' (known: "
                         f"{sorted(KNOWN_BACKENDS)})")
    if name not in KNOWN_BACKENDS:
        raise ValueError(f"unknown scenario backend {name!r} "
                         f"(known: {sorted(KNOWN_BACKENDS)})")
    return name


def resolve_backend(sc: "Scenario", override: str | None = None) -> str:
    """Precedence: explicit override > the card twin of the scenario's
    declared default."""
    if override:
        return _check_backend(override)
    return CARD_BACKENDS.get(sc.backend, sc.backend)


def make_scenario_backend(name: str):
    """The crypto backend a run on `name` uses (see KNOWN_BACKENDS).
    The card's names raise without a card."""
    from tendermint_tpu_torch.crypto.backend import CudaBackend, PythonBackend
    from tendermint_tpu_torch.crypto.supervised import SupervisedBackend
    _check_backend(name)
    if name == "python":
        return PythonBackend()
    if name == "cuda":
        return CudaBackend()
    if name in ("rig", "cuda-rig"):
        dev = CudaBackend() if name == "cuda-rig" else PythonBackend()
        return SupervisedBackend([("dev", dev), ("python", PythonBackend())],
                                 **RIG_KNOBS)
    return SupervisedBackend.build("cuda" if name == "ladder" else name)


def device_rung(ctx: "ScenarioContext"):
    """The "dev" rung of a ladder a scenario body builds by hand: a
    CudaBackend when the run is on the card, else a PythonBackend (the
    JAX catalog's stand-in)."""
    from tendermint_tpu_torch.crypto.backend import CudaBackend, PythonBackend
    return CudaBackend() if ctx.backend_name in ON_CARD else PythonBackend()


class Scenario:
    """A registered scenario: body + named safety/liveness invariants.

    `body(ctx)` composes injectors and returns a JSON-safe observations
    dict; each invariant is `(name, fn)` with `fn(ctx, obs)` raising
    InvariantViolation on failure.  Every shipped scenario must carry at
    least one safety AND one liveness invariant — registration enforces
    it so a scenario cannot silently ship without a post-mortem."""

    def __init__(self, name: str, description: str, body,
                 safety: list, liveness: list, smoke: bool = False,
                 budget_s: float | None = None,
                 backend: str | None = None,
                 budgets: dict | None = None):
        if not safety or not liveness:
            raise ValueError(
                f"scenario {name!r} needs >=1 safety and >=1 liveness "
                f"invariant (got {len(safety)}/{len(liveness)})")
        self.name = name
        self.description = description
        self.body = body
        self.safety = list(safety)
        self.liveness = list(liveness)
        self.smoke = smoke
        # declared wall-clock budget per run: a run over budget is a
        # BUDGET BREACH (soak exits nonzero on it, the chaos ledger
        # records it) — a fault-path latency regression bisects exactly
        # like a correctness regression
        self.budget_s = float(budget_s) if budget_s is not None else (
            DEFAULT_SMOKE_BUDGET_S if smoke else DEFAULT_STRESS_BUDGET_S)
        # default crypto backend for the rig (see KNOWN_BACKENDS);
        # python keeps the smoke tier deterministic, big rigs declare a
        # supervised ladder; a run that names none goes to the card twin
        self.backend = backend or DEFAULT_SCENARIO_BACKEND
        if self.backend not in KNOWN_BACKENDS:
            raise ValueError(
                f"scenario {name!r}: unknown backend {self.backend!r} "
                f"(known: {sorted(KNOWN_BACKENDS)})")
        # metric-level budgets alongside the wall-clock one: each entry
        # maps a metric the body reports (obs['budget_metrics'][name] or
        # obs[name]) to a bound — a bare number is a max, or an explicit
        # {'max': x} / {'min': x}.  A violated OR MISSING metric is a
        # budget breach, ledgered per seed like the wall-clock budget.
        self.budgets = _normalize_budgets(name, budgets)


# default declared budgets (seconds per run) when a scenario doesn't
# declare its own via register(budget_s=...)
DEFAULT_SMOKE_BUDGET_S = 120.0
DEFAULT_STRESS_BUDGET_S = 420.0

SCENARIOS: dict[str, Scenario] = {}


def _normalize_budgets(name: str, budgets: dict | None) -> dict:
    """Validate + canonicalize a metric-budget declaration into
    {metric: {"max": float} | {"min": float} | both}."""
    out: dict[str, dict] = {}
    for metric, spec in (budgets or {}).items():
        if isinstance(spec, bool) or not isinstance(
                spec, (int, float, dict)):
            raise ValueError(
                f"scenario {name!r}: budget for {metric!r} must be a "
                f"number (max) or a {{'max'/'min': number}} dict, "
                f"got {spec!r}")
        if isinstance(spec, dict):
            if not spec or not set(spec) <= {"max", "min"}:
                raise ValueError(
                    f"scenario {name!r}: budget for {metric!r} allows "
                    f"only 'max'/'min' keys, got {sorted(spec)}")
            out[metric] = {k: float(v) for k, v in spec.items()}
        else:
            out[metric] = {"max": float(spec)}
    return out


def register(name: str, description: str, safety: list, liveness: list,
             smoke: bool = False, budget_s: float | None = None,
             backend: str | None = None, budgets: dict | None = None):
    """Decorator: `@register("byz-equivocation", "...", safety=[...],
    liveness=[...])` over the scenario body."""
    def deco(fn):
        if name in SCENARIOS:
            raise ValueError(f"duplicate scenario {name!r}")
        SCENARIOS[name] = Scenario(name, description, fn,
                                   safety, liveness, smoke=smoke,
                                   budget_s=budget_s, backend=backend,
                                   budgets=budgets)
        return fn
    return deco


class ScenarioResult:
    def __init__(self, name: str, seed: int, ok: bool, failures: list[str],
                 event_log_hash: str, duration_s: float,
                 observations: dict, artifact_dir: str | None,
                 budget_s: float | None = None,
                 budget_breaches: list[str] | None = None,
                 backend: str | None = None,
                 budget_metrics: dict | None = None):
        self.name = name
        self.seed = seed
        self.ok = ok
        self.failures = failures
        self.event_log_hash = event_log_hash
        self.duration_s = duration_s
        self.observations = observations
        self.artifact_dir = artifact_dir
        self.budget_s = budget_s
        # breaches are tracked apart from invariant failures: the run's
        # VERDICT stays about correctness, but soak exits nonzero on both
        self.budget_breaches = list(budget_breaches or [])
        self.backend = backend
        # per-metric verdicts: {metric: {value, max?, min?, ok}} — what
        # the per-seed chaos-ledger entries carry next to the wall clock
        self.budget_metrics = dict(budget_metrics or {})

    def to_dict(self) -> dict:
        return {"scenario": self.name, "seed": self.seed, "ok": self.ok,
                "failures": self.failures,
                "event_log_hash": self.event_log_hash,
                "duration_s": round(self.duration_s, 3),
                "budget_s": self.budget_s,
                "budget_breaches": self.budget_breaches,
                "backend": self.backend,
                "budget_metrics": _json_safe(self.budget_metrics),
                "observations": _json_safe(self.observations),
                "artifact_dir": self.artifact_dir}


def _json_safe(obj):
    """Coerce observation values for the manifest: bytes become hex,
    unknown objects their repr — a dump must never fail the dumper."""
    if isinstance(obj, dict):
        return {str(k): _json_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_json_safe(v) for v in obj]
    if isinstance(obj, (bytes, bytearray)):
        return obj.hex()
    if isinstance(obj, (str, int, float, bool)) or obj is None:
        return obj
    return repr(obj)


def artifacts_root(override: str | None = None) -> str:
    return override or os.path.join(os.getcwd(), "chaos_artifacts")


def _dump_artifacts(ctx: ScenarioContext, result: ScenarioResult,
                    root: str) -> str:
    d = os.path.join(root, f"{ctx.scenario.name}-seed{ctx.seed}")
    os.makedirs(d, exist_ok=True)
    ctx.recorder.dump(os.path.join(d, "trace.json"))
    files = [("metrics.json", ctx.metric_phases),
             ("events.json", ctx.log.to_dict()),
             ("result.json", result.to_dict())]
    # merged consensus timeline + doctor, rebuilt from the lifecycle
    # spans in the recorder ring — so any failing/breaching rig run
    # ships its per-node waterfall in the triage bundle
    from tendermint_tpu_torch import telemetry
    records = telemetry.records_from_spans(ctx.recorder.snapshot())
    if records:
        timeline = telemetry.build_timeline(records)
        files.append(("timeline.json", telemetry.to_chrome_trace(timeline)))
        files.append(("consensus_doctor.json",
                      telemetry.consensus_doctor(timeline)))
    for fname, payload in files:
        tmp = os.path.join(d, fname + ".tmp")
        with open(tmp, "w") as f:
            json.dump(_json_safe(payload), f, indent=1)
        os.replace(tmp, os.path.join(d, fname))
    return d


def _check_metric_budgets(sc: Scenario, obs: dict) -> tuple[list[str], dict]:
    """Evaluate the scenario's declared metric budgets against the
    body's reported values.  Returns (breach strings, per-metric
    verdicts).  A metric the body failed to report is itself a breach —
    a budget that silently stopped being measured must not read as
    green."""
    breaches: list[str] = []
    verdicts: dict[str, dict] = {}
    reported = obs.get("budget_metrics") or {}
    for metric, spec in sc.budgets.items():
        val = reported.get(metric, obs.get(metric))
        verdict = dict(spec)
        if isinstance(val, bool) or not isinstance(val, (int, float)):
            verdict.update(value=None, ok=False)
            breaches.append(
                f"metric {metric} missing from observations "
                f"(declared budget {spec}) — the budget was not measured")
        else:
            ok = True
            if "max" in spec and val > spec["max"]:
                ok = False
                breaches.append(f"metric {metric}={val:g} over declared "
                                f"max {spec['max']:g}")
            if "min" in spec and val < spec["min"]:
                ok = False
                breaches.append(f"metric {metric}={val:g} under declared "
                                f"min {spec['min']:g}")
            verdict.update(value=val, ok=ok)
        verdicts[metric] = verdict
    return breaches, verdicts


def run_scenario(name: str, seed: int = DEFAULT_SEED,
                 artifacts: str | None = None,
                 keep_artifacts: bool = False,
                 backend: str | None = None) -> ScenarioResult:
    """Run one registered scenario end to end: build the resolved crypto
    backend and the run's ChaosConfig onto the context, execute the body,
    snapshot metrics, run the safety+liveness post-mortem, check
    wall-clock and metric budgets, and dump artifacts on any failure OR
    budget breach (always, when `keep_artifacts`).  Never raises on
    scenario failure — the result carries the verdict; raises on unknown
    scenario or backend names, and out of the backend's construction (a
    card backend without a card) before the body runs."""
    sc = SCENARIOS.get(name)
    if sc is None:
        raise KeyError(f"unknown scenario {name!r}; "
                       f"known: {sorted(SCENARIOS)}")
    backend_name = resolve_backend(sc, backend)
    ctx = ScenarioContext(sc, seed)
    ctx.plan("scenario", name=name, seed=seed)
    # part of the hashed schedule: a replay on a different rung is a
    # DIFFERENT experiment and must not report MATCH
    ctx.plan("backend", name=backend_name)
    ctx.backend_name = backend_name
    ctx.backend = make_scenario_backend(backend_name)
    failures: list[str] = []
    obs: dict = {}
    t0 = time.perf_counter()
    ctx.snapshot_metrics("start")
    with ctx.recorder.span("scenario.run", cat=tracing.CAT_NONE,
                           scenario=name, seed=seed):
        try:
            obs = sc.body(ctx) or {}
        except InvariantViolation as e:
            failures.append(f"body: {e}")
        except Exception as e:  # noqa: BLE001 - the post-mortem must
            # still run and the trace must still dump on ANY failure
            log.error("scenario body crashed", scenario=name,
                      error=f"{type(e).__name__}: {e}")
            failures.append(f"body: {type(e).__name__}: {e}")
    ctx.snapshot_metrics("end")
    for kind, invariants in (("safety", sc.safety),
                             ("liveness", sc.liveness)):
        for inv_name, fn in invariants:
            try:
                fn(ctx, obs)
                ctx.note("invariant", name=inv_name, kind=kind, ok=True)
            except AssertionError as e:
                failures.append(f"{kind}:{inv_name}: {e}")
                ctx.note("invariant", name=inv_name, kind=kind, ok=False,
                         error=str(e))
            except Exception as e:  # noqa: BLE001 - an invariant that
                # crashes is a failed invariant, not a passed one
                failures.append(
                    f"{kind}:{inv_name}: {type(e).__name__}: {e}")
                ctx.note("invariant", name=inv_name, kind=kind, ok=False,
                         error=f"{type(e).__name__}: {e}")
    duration_s = time.perf_counter() - t0
    breaches: list[str] = []
    if sc.budget_s is not None and duration_s > sc.budget_s:
        breaches.append(
            f"wall-clock {duration_s:.1f}s over declared budget "
            f"{sc.budget_s:.1f}s")
    metric_breaches, budget_metrics = _check_metric_budgets(sc, obs)
    breaches.extend(metric_breaches)
    result = ScenarioResult(
        name=name, seed=seed, ok=not failures, failures=failures,
        event_log_hash=ctx.log.hash(),
        duration_s=duration_s,
        observations=obs, artifact_dir=None,
        budget_s=sc.budget_s, budget_breaches=breaches,
        backend=backend_name, budget_metrics=budget_metrics)
    if breaches:
        log.warn("scenario over budget", scenario=name, seed=seed,
                 duration_s=round(duration_s, 1), budget_s=sc.budget_s,
                 breaches=len(breaches))
    # a budget breach files the same durable triage bundle an invariant
    # failure does: nightly CI red must always leave the evidence behind
    if failures or breaches or keep_artifacts:
        try:
            result.artifact_dir = _dump_artifacts(
                ctx, result, artifacts_root(artifacts))
            log.info("scenario artifacts dumped", scenario=name,
                     dir=result.artifact_dir)
        except OSError as e:
            log.error("scenario artifact dump failed", scenario=name,
                      error=str(e))
    return result


# -- seed-sweep soak ------------------------------------------------------

CHAOS_LEDGER_SCHEMA = "tpu-bft-chaos-ledger/1"
# one line per (scenario, seed) run: the per-seed budget verdicts
# (commit_latency_p99, rounds_per_height, ...) next to the wall clock,
# so a single seed's regression is greppable without re-running the sweep
CHAOS_RUN_SCHEMA = "tpu-bft-chaos-run/1"
DEFAULT_CHAOS_LEDGER = "CHAOS_LEDGER.jsonl"


def parse_seed_range(spec: str) -> list[int]:
    """`"A:B"` -> half-open [A, B) (so `0:25` is 25 seeds); a bare
    integer is a single-seed range."""
    spec = spec.strip()
    try:
        if ":" not in spec:
            return [int(spec)]
        a_s, b_s = spec.split(":", 1)
        a, b = int(a_s), int(b_s)
    except ValueError:
        raise ValueError(
            f"bad seed range {spec!r}: expected 'A:B' (half-open) or a "
            f"single integer") from None
    if b <= a:
        raise ValueError(f"bad seed range {spec!r}: B must be > A "
                         f"(half-open [A, B))")
    return list(range(a, b))


def run_sweep(names: list[str], seeds: list[int],
              artifacts: str | None = None, keep_artifacts: bool = False,
              ledger_path: str | None = None,
              progress=None, backend: str | None = None) -> dict:
    """Soak: run every scenario in `names` across every seed in `seeds`,
    aggregate per-scenario stats, and (unless `ledger_path` is None)
    append one per-run chaos-ledger line per (scenario, seed) — carrying
    the metric-budget verdicts — plus an aggregate entry whose
    per-scenario `runs_per_sec` rate plugs into
    `utils.ledger.compute_deltas`: a fault-path latency regression shows
    up in `cli chaos soak` history exactly like a bench regression.
    `progress`, when given, is called with each ScenarioResult as it
    lands (never-silent soak reporting).  `backend` overrides every
    scenario's declared crypto rung for the whole sweep."""
    unknown = [n for n in names if n not in SCENARIOS]
    if unknown:
        raise KeyError(f"unknown scenarios {unknown}; "
                       f"known: {sorted(SCENARIOS)}")
    if not seeds:
        raise ValueError("empty seed list")
    results: list[ScenarioResult] = []
    agg: dict[str, dict] = {
        n: {"runs": 0, "failures": 0, "breaches": 0,
            "budget_s": SCENARIOS[n].budget_s, "total_duration_s": 0.0,
            "max_duration_s": 0.0, "failed_seeds": [], "breached_seeds": []}
        for n in names}
    for n in names:
        for seed in seeds:
            r = run_scenario(n, seed=seed, artifacts=artifacts,
                             keep_artifacts=keep_artifacts,
                             backend=backend)
            results.append(r)
            a = agg[n]
            a["runs"] += 1
            a["total_duration_s"] += r.duration_s
            a["max_duration_s"] = max(a["max_duration_s"], r.duration_s)
            if not r.ok:
                a["failures"] += 1
                a["failed_seeds"].append(seed)
            if r.budget_breaches:
                a["breaches"] += 1
                a["breached_seeds"].append(seed)
            if progress is not None:
                progress(r)
    configs: dict[str, dict] = {}
    for n, a in agg.items():
        total = a.pop("total_duration_s")
        a["mean_duration_s"] = round(total / a["runs"], 3)
        a["max_duration_s"] = round(a["max_duration_s"], 3)
        # headline rate for ledger.compute_deltas/render_history: a
        # latency regression in the fault path appears as a rate drop
        a["runs_per_sec"] = round(a["runs"] / total, 4) if total > 0 else 0.0
        configs[n] = dict(a)
    summary = {
        "schema": CHAOS_LEDGER_SCHEMA,
        "seeds": [seeds[0], seeds[-1] + 1] if seeds == list(
            range(seeds[0], seeds[-1] + 1)) else list(seeds),
        "n_seeds": len(seeds),
        "configs": configs,
        "total_runs": len(results),
        "total_failures": sum(a["failures"] for a in configs.values()),
        "total_breaches": sum(a["breaches"] for a in configs.values()),
    }
    if ledger_path is not None:
        from tendermint_tpu_torch.utils import ledger as ledgermod
        stamp = time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())
        for r in results:
            ledgermod.append_entry(ledger_path, {
                "schema": CHAOS_RUN_SCHEMA, "scenario": r.name,
                "seed": r.seed, "ok": r.ok, "backend": r.backend,
                "duration_s": round(r.duration_s, 3),
                "budget_s": r.budget_s,
                "budget_breaches": r.budget_breaches,
                "budget_metrics": _json_safe(r.budget_metrics),
                "event_log_hash": r.event_log_hash,
                "artifact_dir": r.artifact_dir,
                "timestamp": stamp})
        entry = dict(summary)
        entry["timestamp"] = stamp
        prior = [e for e in ledgermod.load(ledger_path)
                 if e.get("schema") == CHAOS_LEDGER_SCHEMA]
        summary["deltas"] = ledgermod.compute_deltas(prior, configs)
        ledgermod.append_entry(ledger_path, entry)
        summary["ledger_path"] = os.path.abspath(ledger_path)
    return {"summary": summary, "results": results}
