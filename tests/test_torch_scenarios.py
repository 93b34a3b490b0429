"""The port's scenario engine and core catalogue held against the JAX
package's (`tests/test_scenarios.py`'s contract, on the CPU backends):

- the registry: the port registers every JAX scenario (21) with the JAX
  name, description, tier, wall-clock and metric budgets, declared
  backend and invariant names, and `SMOKE_ORDER` is the JAX list;
- the smoke tier on `backend="python"` (the catalogue's four, then
  `snapshot-torn-tail`, `batchplane-isolation` and `eviction-storm`):
  each passes, and its sealed plan stream, event-log hash and
  deterministic observations equal the JAX run's on the same seed;
- `snapshot-torn-tail` leaves no fail point armed and no crash callback
  set, at either of its seed-chosen crash sites;
- the engine's guarantees (seed determinism, registration checks,
  unknown names, the artifact bundle on failure, a crashing body, a
  seed-range sweep) and `cli chaos list | run | replay | smoke | soak |
  nightly` (their ledgers in the JAX schema);
- the port's rules: a run that names no backend goes to the card (and
  raises here, where there is none), and "tpu" is refused.
"""

import json
import os

import pytest

from tendermint_tpu import scenarios as jsc
from tendermint_tpu_torch import scenarios as sc
from tendermint_tpu_torch.scenarios import (SCENARIOS, SMOKE_ORDER,
                                            InvariantViolation, register,
                                            run_scenario)

pytestmark = pytest.mark.faults

SEED = 11
PORTED = sorted(n for n in SCENARIOS if not n.startswith("_"))
SMOKE = [n for n in SMOKE_ORDER if n in SCENARIOS]

# observations that are a pure function of (scenario, seed)
DETERMINISTIC = {
    "device-wrong-answer": ("wrong_answers", "n_calls", "cleared_ok"),
    "evidence-flood": ("accepted_real", "accepted_bogus", "pool_size",
                       "n_real", "n_bogus", "progressed"),
    "byz-equivocation": ("reached", "captured", "evidence_wellformed",
                         "honest_heights"),
    "device-rung-walk": ("synced", "recovered", "chain_ok", "app_hash_ok",
                         "evicted"),
    "snapshot-torn-tail": ("crashed", "crash_site", "valid_heights",
                           "reject_reasons", "restored_height", "replayed",
                           "parity_state", "parity_app", "blamed"),
    "eviction-storm": ("offered", "outcomes", "filled", "evict_log_len",
                       "rejected_delta", "evicted_delta", "recovery_exact",
                       "recovered_count", "survivor_count",
                       "resubmit_outcomes", "committed_resubmit"),
    "batchplane-isolation": ("bad_lanes",),
}


@pytest.fixture(autouse=True)
def _no_jax_env(monkeypatch):
    for k in ("TM_SCENARIO_BACKEND", "TM_SCENARIO_ARTIFACTS",
              "TM_CHAOS_CRYPTO", "TM_CHAOS_SEED"):
        monkeypatch.delenv(k, raising=False)


def _spec(s):
    return {"description": s.description, "smoke": s.smoke,
            "budget_s": s.budget_s, "budgets": s.budgets,
            "backend": s.backend,
            "safety": [n for n, _ in s.safety],
            "liveness": [n for n, _ in s.liveness]}


def test_registry_equals_jax():
    jax_names = {n for n in jsc.SCENARIOS if not n.startswith("_")}
    assert set(PORTED) == jax_names
    assert len(PORTED) == 21
    for name in PORTED:
        assert _spec(SCENARIOS[name]) == _spec(jsc.SCENARIOS[name]), name
    assert SMOKE_ORDER == jsc.SMOKE_ORDER
    assert SMOKE == [n for n in jsc.SMOKE_ORDER if n in jsc.SCENARIOS] == [
        "device-wrong-answer", "evidence-flood", "byz-equivocation",
        "device-rung-walk", "snapshot-torn-tail", "batchplane-isolation",
        "eviction-storm"]
    assert sorted(n for n in PORTED if SCENARIOS[n].smoke) == sorted(SMOKE)
    assert sc.KNOWN_BACKENDS == ("python", "rig", "cuda", "cuda-rig",
                                 "native", "ladder")
    assert (sc.DEFAULT_SEED, sc.CHAOS_RUN_SCHEMA, sc.DEFAULT_CHAOS_LEDGER) \
        == (jsc.DEFAULT_SEED, jsc.CHAOS_RUN_SCHEMA, jsc.DEFAULT_CHAOS_LEDGER)
    from tendermint_tpu.scenarios import engine as jeng
    from tendermint_tpu_torch.scenarios import engine as eng
    assert eng.CHAOS_LEDGER_SCHEMA == jeng.CHAOS_LEDGER_SCHEMA


def _run(mod, name, tmp_path, seed=SEED):
    r = mod.run_scenario(name, seed=seed, backend="python",
                         artifacts=str(tmp_path / mod.__name__),
                         keep_artifacts=True)
    with open(os.path.join(r.artifact_dir, "events.json")) as f:
        events = json.load(f)
    return r, events


@pytest.mark.parametrize("name", SMOKE)
def test_smoke_scenario_matches_jax(name, tmp_path):
    """Every catalogue smoke scenario passes on the python backend, and
    its plan stream, event-log hash and deterministic observations are
    the JAX run's."""
    r, events = _run(sc, name, tmp_path)
    jr, jevents = _run(jsc, name, tmp_path)
    assert r.ok, f"{name} failed: {r.failures}"
    assert jr.ok, f"JAX {name} failed: {jr.failures}"
    assert not r.budget_breaches, r.budget_breaches
    assert events["plan"] == jevents["plan"]
    assert r.event_log_hash == jr.event_log_hash == events["hash"]
    for key in DETERMINISTIC[name]:
        assert r.observations[key] == jr.observations[key], key
    assert r.backend == "python"
    for fname in ("trace.json", "metrics.json", "result.json"):
        assert os.path.exists(os.path.join(r.artifact_dir, fname))


def test_torn_tail_leaves_no_fail_point_armed():
    """Both crash sites (the seed chooses one): the crash fires, and after
    the run no fail point is armed and no crash callback is set."""
    from tendermint_tpu_torch.utils import fail
    sites = {}
    for seed in range(12):
        r = run_scenario("snapshot-torn-tail", seed=seed, backend="python")
        assert r.ok, r.failures
        assert r.observations["crashed"]
        assert fail._target is None and fail._callback is None
        sites.setdefault(r.observations["crash_site"], seed)
        if len(sites) == 2:
            break
    assert set(sites) == {"Snapshot.chunkWritten", "Snapshot.chunksWritten"}


def test_event_log_hash_is_seed_deterministic():
    a = run_scenario("device-wrong-answer", seed=SEED, backend="python")
    b = run_scenario("device-wrong-answer", seed=SEED, backend="python")
    c = run_scenario("device-wrong-answer", seed=SEED + 1, backend="python")
    assert a.ok, a.failures
    assert a.event_log_hash == b.event_log_hash
    assert a.event_log_hash != c.event_log_hash
    # the backend is part of the hashed plan
    d = run_scenario("device-wrong-answer", seed=SEED, backend="rig")
    assert d.ok, d.failures
    assert d.event_log_hash != a.event_log_hash


def test_registration_requires_safety_and_liveness():
    inv = ("x", lambda ctx, obs: None)
    with pytest.raises(ValueError, match="safety"):
        register("_toy-no-liveness", "d", safety=[inv],
                 liveness=[])(lambda ctx: {})
    with pytest.raises(ValueError, match="safety"):
        register("_toy-no-safety", "d", safety=[],
                 liveness=[inv])(lambda ctx: {})
    assert "_toy-no-liveness" not in SCENARIOS
    assert "_toy-no-safety" not in SCENARIOS
    with pytest.raises(ValueError, match="duplicate"):
        register("byz-equivocation", "d", safety=[inv],
                 liveness=[inv])(lambda ctx: {})
    with pytest.raises(ValueError, match="unknown backend"):
        register("_toy-tpu", "d", safety=[inv], liveness=[inv],
                 backend="tpu")(lambda ctx: {})


def test_unknown_names_raise():
    with pytest.raises(KeyError, match="unknown scenario"):
        run_scenario("no-such-scenario")
    with pytest.raises(ValueError, match="unknown scenario backend"):
        run_scenario("device-wrong-answer", backend="gpu")


def test_failure_dumps_artifact_bundle(tmp_path):
    def body(ctx):
        ctx.plan("toy", x=1)
        ctx.note("toy.ran")
        return {"fine": True}

    def bad_safety(ctx, obs):
        raise InvariantViolation("toy safety evidence: x != y")

    register("_toy-failing", "always fails",
             safety=[("toy-safety", bad_safety)],
             liveness=[("toy-liveness", lambda ctx, obs: None)])(body)
    try:
        r = run_scenario("_toy-failing", seed=3, artifacts=str(tmp_path),
                         backend="python")
    finally:
        SCENARIOS.pop("_toy-failing", None)
    assert not r.ok
    assert any("toy safety evidence" in f for f in r.failures)
    assert r.artifact_dir == str(tmp_path / "_toy-failing-seed3")
    for fname in ("trace.json", "metrics.json", "events.json",
                  "result.json"):
        assert os.path.exists(os.path.join(r.artifact_dir, fname)), fname
    with open(os.path.join(r.artifact_dir, "result.json")) as f:
        manifest = json.load(f)
    assert manifest["scenario"] == "_toy-failing"
    assert manifest["seed"] == 3
    assert manifest["backend"] == "python"
    assert manifest["event_log_hash"] == r.event_log_hash
    assert any("toy safety evidence" in f for f in manifest["failures"])
    with open(os.path.join(r.artifact_dir, "events.json")) as f:
        events = json.load(f)
    assert {"event": "toy", "x": 1} in events["plan"]
    assert any(n["event"] == "toy.ran" for n in events["notes"])


def test_body_crash_is_a_failure_not_an_exception(tmp_path):
    register("_toy-crashing", "body raises",
             safety=[("s", lambda ctx, obs: None)],
             liveness=[("l", lambda ctx, obs: None)])(lambda ctx: 1 / 0)
    try:
        r = run_scenario("_toy-crashing", seed=1, artifacts=str(tmp_path),
                         backend="python")
    finally:
        SCENARIOS.pop("_toy-crashing", None)
    assert not r.ok
    assert any("ZeroDivisionError" in f for f in r.failures)
    assert r.artifact_dir and os.path.exists(
        os.path.join(r.artifact_dir, "trace.json"))


def test_seed_range_sweep_of_a_smoke_scenario(tmp_path):
    from tendermint_tpu_torch.scenarios import parse_seed_range, run_sweep
    from tendermint_tpu_torch.utils import ledger as ledgermod

    seeds = parse_seed_range("0:3")
    assert seeds == [0, 1, 2] == jsc.parse_seed_range("0:3")
    for bad in ("3:3", "x", "4:1"):
        with pytest.raises(ValueError, match="bad seed range"):
            parse_seed_range(bad)
    ledger_path = str(tmp_path / "ledger.jsonl")
    out = run_sweep(["device-wrong-answer"], seeds, backend="python",
                    artifacts=str(tmp_path), ledger_path=ledger_path)
    cfg = out["summary"]["configs"]["device-wrong-answer"]
    assert cfg["runs"] == 3
    assert cfg["failures"] == 0 and cfg["breaches"] == 0
    assert cfg["runs_per_sec"] > 0
    assert len(out["results"]) == 3
    entries = ledgermod.load(ledger_path)
    runs = [e for e in entries if e.get("schema") == sc.CHAOS_RUN_SCHEMA]
    aggs = [e for e in entries if e.get("schema") != sc.CHAOS_RUN_SCHEMA]
    assert sorted(e["seed"] for e in runs) == seeds
    assert all(e["scenario"] == "device-wrong-answer"
               and e["backend"] == "python" for e in runs)
    assert len(aggs) == 1
    rate, unit = ledgermod.rate_of(
        "device-wrong-answer", aggs[0]["configs"]["device-wrong-answer"])
    assert rate and rate > 0 and unit == "runs_per_sec"
    # the hashes of the sweep are the JAX sweep's
    jout = jsc.run_sweep(["device-wrong-answer"], seeds, backend="python",
                         artifacts=str(tmp_path / "jax"))
    assert [r.event_log_hash for r in out["results"]] == \
        [r.event_log_hash for r in jout["results"]]


# -- the card by default ------------------------------------------------------

def test_no_backend_means_the_card_and_raises_without_one():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default run would use it")
    for name in SMOKE + ["live-rounds-100-chaos", "mempool-flood"]:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run_scenario(name)
    assert sc.resolve_backend(SCENARIOS["device-wrong-answer"]) == "cuda"
    assert sc.resolve_backend(SCENARIOS["live-rounds-50"]) == "cuda-rig"
    assert sc.resolve_backend(SCENARIOS["live-rounds-50"], "rig") == "rig"
    assert sc.resolve_backend(SCENARIOS["mempool-flood"]) == "cuda-rig"


def test_tpu_is_refused_naming_cuda():
    with pytest.raises(ValueError, match="'cuda'"):
        run_scenario("device-wrong-answer", backend="tpu")
    from tendermint_tpu_torch.cli import main
    with pytest.raises(SystemExit):
        main(["chaos", "run", "--scenario", "device-wrong-answer",
              "--backend", "tpu"])


def test_scenario_backends_are_built_as_named():
    from tendermint_tpu_torch.crypto.backend import PythonBackend
    from tendermint_tpu_torch.crypto.supervised import SupervisedBackend
    from tendermint_tpu_torch.scenarios.engine import make_scenario_backend
    assert isinstance(make_scenario_backend("python"), PythonBackend)
    rig = make_scenario_backend("rig")
    assert isinstance(rig, SupervisedBackend)
    st = rig.supervisor_status()
    assert [r["name"] for r in st["rungs"]] == ["dev", "python"]
    assert (st["breaker_threshold"], st["breaker_cooldown_s"], st["retries"],
            st["call_timeout_s"], st["chaos"]) == (2, 0.5, 0, 30.0, None)
    native = make_scenario_backend("native")
    assert [r["name"] for r in native.supervisor_status()["rungs"]] == \
        ["native", "python"]


# -- CLI ---------------------------------------------------------------------

def test_cli_chaos_list(capsys):
    from tendermint_tpu.cli import main as jmain
    from tendermint_tpu_torch.cli import main
    assert main(["chaos", "list"]) == 0
    out = capsys.readouterr().out
    for name in PORTED:
        assert name in out
    assert main(["chaos", "list", "--json"]) == 0
    catalog = json.loads(capsys.readouterr().out)
    assert catalog["byz-equivocation"]["tier"] == "smoke"
    assert catalog["crash-restart-storm"]["tier"] == "stress"
    assert catalog["partition-heal"]["safety"]
    assert jmain(["chaos", "list", "--json"]) == 0
    jcatalog = json.loads(capsys.readouterr().out)
    assert catalog == {n: jcatalog[n] for n in catalog}


def test_cli_chaos_run_then_replay_matches(tmp_path, capsys):
    from tendermint_tpu_torch.cli import main
    rc = main(["chaos", "run", "--scenario", "device-wrong-answer",
               "--seed", "7", "--backend", "python",
               "--artifacts", str(tmp_path), "--keep-artifacts"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "PASS device-wrong-answer" in out
    manifest = str(tmp_path / "device-wrong-answer-seed7" / "result.json")
    assert os.path.exists(manifest)
    rc = main(["chaos", "replay", "--manifest", manifest])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "MATCH" in out
    # a manifest whose hash no run gives reports DIVERGED
    with open(manifest) as f:
        m = json.load(f)
    m["event_log_hash"] = "0" * 64
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps(m))
    assert main(["chaos", "replay", "--manifest", str(bad)]) == 1
    assert "DIVERGED" in capsys.readouterr().out


def test_cli_chaos_smoke_reports_budget_skips(capsys):
    """The smoke runner never silently drops scenarios: past the
    wall-clock budget the remainder is reported as SKIP lines
    (`tests/test_scenarios.py`'s case, on the python backend)."""
    from tendermint_tpu_torch.cli import main
    rc = main(["chaos", "smoke", "--budget", "0.05", "--backend", "python"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "PASS device-wrong-answer" in out
    for name in SMOKE[1:]:
        assert f"SKIP {name} (budget 0s spent)" in out
    assert out.splitlines()[-1].startswith(
        f"chaos smoke: 1/1 passed, {len(SMOKE) - 1} skipped in ")


def _toy(name, body, budgets):
    register(name, "toy", safety=[("s", lambda ctx, obs: None)],
             liveness=[("l", lambda ctx, obs: None)], budgets=budgets,
             backend="python")(body)


def _ledger(path):
    from tendermint_tpu.utils import ledger as jledger
    from tendermint_tpu_torch.scenarios.engine import CHAOS_LEDGER_SCHEMA
    from tendermint_tpu_torch.utils import ledger as ledgermod
    entries = ledgermod.load(path)
    assert entries == jledger.load(path)
    runs = [e for e in entries if e.get("schema") == sc.CHAOS_RUN_SCHEMA]
    aggs = [e for e in entries if e.get("schema") == CHAOS_LEDGER_SCHEMA]
    assert len(runs) + len(aggs) == len(entries)
    return runs, aggs


def test_cli_chaos_nightly_green_path(tmp_path, capsys):
    """The gate on a passing catalogue subset: per-seed run entries and
    one aggregate row land in the ledger, with the JAX schemas and keys,
    and the exit code is 0 (`tests/test_metric_budgets.py`'s case, on
    the python backend)."""
    from tendermint_tpu_torch.cli import main
    ledger_path = str(tmp_path / "ledger.jsonl")
    rc = main(["chaos", "nightly", "--backend", "python",
               "--scenarios", "device-wrong-answer,byz-equivocation",
               "--seed-range", "0:2", "--budget-ledger", ledger_path,
               "--artifacts", str(tmp_path / "arts")])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "chaos nightly seeds 0:2: 4/4 passed" in out
    runs, aggs = _ledger(ledger_path)
    # a sweep row per scenario, then the nightly's own row
    assert len(runs) == 4 and len(aggs) == 3
    assert sorted((e["scenario"], e["seed"]) for e in runs) == [
        (n, s) for n in ("byz-equivocation", "device-wrong-answer")
        for s in (0, 1)]
    assert all(e["backend"] == "python" and e["ok"] for e in runs)
    nightly = [e for e in aggs if e.get("nightly")]
    assert len(nightly) == 1
    assert set(nightly[0]) == {"schema", "nightly", "seed_range", "n_seeds",
                               "configs", "skipped", "backend", "timestamp"}
    assert nightly[0]["backend"] == "python"
    assert set(nightly[0]["configs"]) == {"device-wrong-answer",
                                          "byz-equivocation"}


def test_cli_chaos_nightly_exits_nonzero_on_breach(tmp_path, capsys):
    """A metric breach anywhere in the sweep: nonzero exit and the
    triage bundle path printed."""
    from tendermint_tpu_torch.cli import main
    _toy("_bgt-red", lambda ctx: {"budget_metrics": {"lat_p99": 9.0}},
         budgets={"lat_p99": {"max": 2.0}})
    try:
        rc = main(["chaos", "nightly", "--scenarios", "_bgt-red",
                   "--backend", "python", "--seed-range", "0:2",
                   "--budget-ledger", str(tmp_path / "ledger.jsonl"),
                   "--artifacts", str(tmp_path / "arts")])
    finally:
        SCENARIOS.pop("_bgt-red", None)
    out = capsys.readouterr().out
    assert rc == 1, out
    assert "triage: " in out
    assert "2 over budget" in out
    runs, _ = _ledger(str(tmp_path / "ledger.jsonl"))
    assert [e["budget_metrics"]["lat_p99"] for e in runs] == [
        {"max": 2.0, "value": 9.0, "ok": False}] * 2


def test_cli_chaos_nightly_skips_are_loud(tmp_path, capsys):
    """A near-zero global budget: the first scenario spends it, the
    rest are SKIPPED and SAY so."""
    from tendermint_tpu_torch.cli import main
    rc = main(["chaos", "nightly", "--backend", "python",
               "--scenarios", "device-wrong-answer,byz-equivocation",
               "--seed-range", "0:2", "--budget", "0.01",
               "--budget-ledger", "",
               "--artifacts", str(tmp_path / "arts")])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "PASS device-wrong-answer" in out
    assert "SKIP byz-equivocation x2 seeds" in out
    assert "1 scenarios skipped" in out


@pytest.mark.parametrize("command", ["nightly", "soak"])
def test_cli_chaos_sweeps_reject_unknown_scenario(command, capsys):
    from tendermint_tpu.cli import main as jmain
    from tendermint_tpu_torch.cli import main
    args = ["chaos", command, "--scenarios", "no-such-rig"]
    assert main(args) == 2 == jmain(args)
    assert "unknown scenarios: no-such-rig" in capsys.readouterr().err


def test_cli_chaos_soak_at_a_tiny_seed_range(tmp_path, capsys):
    """`chaos soak` over one scenario and one seed: its JSON summary and
    its aggregate ledger row have the JAX soak's keys, and the sweep's
    hash is the JAX run's."""
    from tendermint_tpu.cli import main as jmain
    from tendermint_tpu_torch.cli import main
    out = {}
    for pkg, fn in (("port", main), ("jax", jmain)):
        ledger_path = str(tmp_path / f"{pkg}.jsonl")
        args = ["chaos", "soak", "--scenarios", "device-wrong-answer",
                "--seed-range", "3:4", "--budget-ledger", ledger_path,
                "--artifacts", str(tmp_path / pkg), "--keep-artifacts",
                "--json"]
        rc = fn(args + (["--backend", "python"] if pkg == "port" else []))
        printed = capsys.readouterr().out
        assert rc == 0, printed
        out[pkg] = (json.loads(printed), ledger_path)
    (got, path), (want, jpath) = out["port"], out["jax"]
    assert set(got) == set(want)
    assert (got["runs"], got["failures"], got["breaches"], got["skipped"]) \
        == (1, 0, 0, []) == (want["runs"], want["failures"],
                             want["breaches"], want["skipped"])
    assert set(got["configs"]["device-wrong-answer"]) == \
        set(want["configs"]["device-wrong-answer"])
    runs, aggs = _ledger(path)
    _, jaggs = _ledger(jpath)
    assert runs == [] and len(aggs) == len(jaggs) == 1
    assert set(aggs[0]) == set(jaggs[0])
    assert aggs[0]["soak"] and aggs[0]["tier"] == "smoke"
    hashes = []
    for pkg in ("port", "jax"):
        with open(tmp_path / pkg / "device-wrong-answer-seed3"
                  / "result.json") as f:
            hashes.append(json.load(f)["event_log_hash"])
    assert hashes[0] == hashes[1]
