"""Tier-1 gate: the port's tmlint over `tendermint_tpu_torch/` must report
zero non-baselined findings, as `tests/test_tmlint_repo.py` holds the JAX
package.  Policy: the baseline is empty, and hot-path modules (ops/,
crypto/, parallel/) may never be baselined — a new implicit sync there
fails even if someone grandfathers it."""

import json
import os
import subprocess
import sys

import pytest

from tendermint_tpu_torch.analysis import (baseline_path, lint_paths,
                                           load_baseline)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

HOT_DIRS = ("ops/", "crypto/", "parallel/")


@pytest.mark.lint
def test_port_has_no_fresh_findings():
    res = lint_paths([os.path.join(REPO, "tendermint_tpu_torch")], root=REPO)
    assert res.files > 100, "lint saw suspiciously few files"
    assert not res.errors, res.errors
    fresh = res.fresh(load_baseline())
    assert fresh == [], "\n" + "\n".join(f.render() for f in fresh)


@pytest.mark.lint
def test_baseline_never_covers_hot_path_modules():
    with open(baseline_path()) as f:
        doc = json.load(f)
    assert doc["schema"] == "tmlint/1"
    offenders = [e for e in doc["findings"]
                 if e["path"].partition("tendermint_tpu_torch/")[2]
                 .startswith(HOT_DIRS)]
    assert offenders == [], (
        "hot-path findings must be fixed, not baselined: "
        + ", ".join(e["fingerprint"] for e in offenders))
    assert doc["findings"] == []


@pytest.mark.lint
def test_cli_lint_exits_zero_on_repo():
    out = subprocess.run(
        [sys.executable, "-m", "tendermint_tpu_torch.cli", "lint", "--json"],
        capture_output=True, text=True, cwd=REPO, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    doc = json.loads(out.stdout)
    assert doc["fresh_count"] == 0 and doc["files"] > 100
