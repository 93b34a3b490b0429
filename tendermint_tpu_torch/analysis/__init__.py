"""tmlint: AST-based invariant checker for the port.

Copy of `tendermint_tpu/analysis/` for `tendermint_tpu_torch/`: the same
three invariant families — lock discipline across the threaded modules
(the reference leans on Go's race detector, which Python lacks), device
hot-path hygiene (here torch's: implicit host syncs and launch
signatures that follow the batch size), and registration conventions
(unsafe-gating of `debug_*`/`unsafe_*` RPC routes, category-prefixed
span names feeding `utils/attribution.py`, Prometheus-valid metric
names, stress-scenario budgets) — plus the batch-plane producer rule.
Every rule reads the port's own tables and imports nothing of JAX.

Run it as `python -m tendermint_tpu_torch.cli lint` (add `--json` for
machine output); `tests/test_torch_tmlint_repo.py` runs the same pass in
tier-1.

Rule families (see each module's docstring for details):

- `locks.py`     lock-order / unlocked-write   (lock discipline)
- `hotpath.py`   torch-host-sync / torch-launch-bucket /
                 bench-scalar-loop (the torch forms of the JAX
                 jax-host-sync / jax-retrace; jax-static-argnums has no
                 torch form)
- `conventions.py` route-gating / route-write-containment /
                 span-category / metric-name / scenario-budget
- `batchplane_rule.py` batchplane-producer (verify work must ride the
                 batch plane, or say at the site why it does not)

Suppression and grandfathering:

- inline: append ``# tmlint: disable=<rule>[,<rule>...]`` (or
  ``disable=all``) to the offending line;
- baseline: `analysis/baseline.json` holds fingerprints of grandfathered
  findings — `cli lint --update-baseline` regenerates it.  It is empty,
  and hot-path modules (`ops/`, `crypto/`, `parallel/`) must never be
  baselined (README "Static analysis").
"""

from tendermint_tpu_torch.analysis.core import (Finding, LintResult,
                                                all_rules, baseline_path,
                                                lint_paths, load_baseline,
                                                save_baseline)

# importing the rule modules registers their rule classes
from tendermint_tpu_torch.analysis import (batchplane_rule, conventions,  # noqa: E402,F401  (registration import)
                                           hotpath, locks)

__all__ = ["Finding", "LintResult", "all_rules", "baseline_path",
           "lint_paths", "load_baseline", "save_baseline"]
