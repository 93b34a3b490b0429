"""The port's scenario engine and core catalogue held against the JAX
package's (`tests/test_scenarios.py`'s contract, on the CPU backends):

- the registry: every scenario the port registers has the JAX name,
  description, tier, wall-clock and metric budgets and invariant names,
  and `SMOKE_ORDER` is the JAX list;
- the catalogue's smoke scenarios on `backend="python"`: each passes,
  and its sealed plan stream, event-log hash and deterministic
  observations equal the JAX run's on the same seed;
- the engine's guarantees (seed determinism, registration checks,
  unknown names, the artifact bundle on failure, a crashing body, a
  seed-range sweep) and `cli chaos list | run | replay`;
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
# the JAX registry's tiers that the port has not registered yet
LATER_TIERS = {"snapshot-torn-tail", "snapshot-join", "snapshot-tamper",
               "batchplane-isolation", "batchplane-flood-isolation",
               "eviction-storm", "mempool-flood"}
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
    assert set(PORTED) == jax_names - LATER_TIERS
    assert len(PORTED) == 14
    for name in PORTED:
        assert _spec(SCENARIOS[name]) == _spec(jsc.SCENARIOS[name]), name
    assert SMOKE_ORDER == jsc.SMOKE_ORDER
    assert SMOKE == ["device-wrong-answer", "evidence-flood",
                     "byz-equivocation", "device-rung-walk"]
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
    for name in SMOKE + ["live-rounds-100-chaos"]:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run_scenario(name)
    assert sc.resolve_backend(SCENARIOS["device-wrong-answer"]) == "cuda"
    assert sc.resolve_backend(SCENARIOS["live-rounds-50"]) == "cuda-rig"
    assert sc.resolve_backend(SCENARIOS["live-rounds-50"], "rig") == "rig"


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
