"""Deterministic Byzantine + failure scenario harness.

`run_scenario(name, seed)` runs one registered scenario: a declarative
composition of fault injectors (byzantine vote streams, evidence
floods, stale/partial-commit replay, partitions, crash-restart storms,
device-fault storms) with a post-mortem of safety and liveness
invariants and flight-recorder artifacts on failure.  See `engine.py`
for the seed-replay contract and `catalog.py` for the shipped
scenarios; drive from the command line with `cli chaos`.

Copy of `tendermint_tpu/scenarios/__init__.py`: it registers the core
catalogue (`catalog`), the big-rig tier (`live`) and the state-sync,
batch-plane and mempool tiers, every scenario of the JAX package.
`fixtures`, `loadgen` and `ingress` are modules of this package that the
engine does not import.
"""

from tendermint_tpu_torch.scenarios.engine import (
    CHAOS_RUN_SCHEMA, DEFAULT_CHAOS_LEDGER, DEFAULT_SEED, KNOWN_BACKENDS,
    SCENARIOS, InvariantViolation, ScenarioResult, artifacts_root,
    parse_seed_range, register, resolve_backend, run_scenario, run_sweep)
from tendermint_tpu_torch.scenarios import catalog  # the shipped set
from tendermint_tpu_torch.scenarios import live    # the big-rig tier
from tendermint_tpu_torch.scenarios import statesync_scenarios  # snapshots
from tendermint_tpu_torch.scenarios import batchplane_scenarios  # the plane
from tendermint_tpu_torch.scenarios import mempool_scenarios  # ingress
from tendermint_tpu_torch.scenarios.catalog import SMOKE_ORDER

__all__ = ["CHAOS_RUN_SCHEMA", "DEFAULT_CHAOS_LEDGER", "DEFAULT_SEED",
           "KNOWN_BACKENDS", "SCENARIOS", "SMOKE_ORDER",
           "InvariantViolation", "ScenarioResult", "artifacts_root",
           "batchplane_scenarios", "catalog", "live", "mempool_scenarios",
           "parse_seed_range", "register", "resolve_backend",
           "run_scenario", "run_sweep", "statesync_scenarios"]
