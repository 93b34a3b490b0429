"""The stress tier of the port's catalogue (faults + slow, as
`tests/test_scenarios_slow.py` is: tier-1's `-m 'not slow'` leaves it
out).  Each stress scenario runs on the CPU backend it declares
("python" or "rig") in both packages with one seed: the port's run
passes, and its sealed plan stream and event-log hash are the JAX
run's, so a wrong port of a body's plan (the adversary cast, the
equivocation heights, the partition schedule) shows.  On the card the
smoke's cell F runs the heaviest two, and `python3 chip_smoke.py
--stress-tier` the four of the state-sync, batch-plane and mempool
tiers.

Run explicitly with:

    python -m pytest tests/test_torch_scenarios_slow.py -m faults

or one at a time with `python -m tendermint_tpu_torch.cli chaos run
--scenario <name> --backend python` (or `rig`).
"""

import json
import os

import pytest

from tendermint_tpu.scenarios import SCENARIOS as JAX_SCENARIOS
from tendermint_tpu.scenarios import run_scenario as jax_run_scenario
from tendermint_tpu_torch.scenarios import SCENARIOS, run_scenario
from tendermint_tpu_torch.scenarios.engine import DEFAULT_SEED

pytestmark = [pytest.mark.faults, pytest.mark.slow]

STRESS = sorted(n for n, sc in SCENARIOS.items() if not sc.smoke
                and not n.startswith("_"))


def test_stress_catalog_is_what_we_think():
    assert STRESS == ["batchplane-flood-isolation", "crash-restart-storm",
                      "device-storm-partition",
                      "equivocation-crash-restart",
                      "live-rounds-100-chaos", "live-rounds-50",
                      "mempool-flood", "partial-commit-replay",
                      "partition-heal", "partition-heal-25",
                      "snapshot-join", "snapshot-tamper",
                      "stale-commit-replay", "stale-replay-partition"]


def test_every_stress_scenario_declares_metric_budgets():
    for name in STRESS:
        sc = SCENARIOS[name]
        assert sc.budgets, f"{name} declares no metric budgets"
        for metric, spec in sc.budgets.items():
            assert set(spec) & {"min", "max"}, \
                f"{name} budget {metric} has neither min nor max"


def _run(run, name, backend, out):
    r = run(name, seed=DEFAULT_SEED, backend=backend, artifacts=out,
            keep_artifacts=True)
    with open(os.path.join(r.artifact_dir, "events.json")) as f:
        return r, json.load(f)


@pytest.mark.parametrize("name", STRESS)
def test_stress_scenario(name, tmp_path):
    backend = SCENARIOS[name].backend
    assert backend == JAX_SCENARIOS[name].backend
    r, events = _run(run_scenario, name, backend, str(tmp_path / "port"))
    jr, jevents = _run(jax_run_scenario, name, backend,
                       str(tmp_path / "jax"))
    assert r.ok, f"{name} failed: {r.failures}"
    assert events["plan"] == jevents["plan"], \
        f"{name}: plan differs from the JAX run's (JAX ok={jr.ok}, " \
        f"failures {jr.failures})"
    assert r.event_log_hash == jr.event_log_hash == events["hash"]
