"""Suppression, baseline, and CLI mechanics of the port's tmlint,
mirroring `tests/test_tmlint_mechanics.py`: an inline disable comment
silences its line, a baselined finding doesn't fail the run, a fresh
finding does, and the `cli lint --json` document round-trips (the same
`tmlint/1` document and fingerprints as the JAX linter's)."""

import json
import textwrap

from tendermint_tpu.analysis import Finding as JFinding
from tendermint_tpu_torch.analysis import (Finding, lint_paths, load_baseline,
                                           save_baseline)
from tendermint_tpu_torch.cli import main as cli_main

VIOLATION = """
    import torch

    def count(xs):
        s = torch.sum(xs)
        return s.item()
"""

SUPPRESSED = """
    import torch

    def count(xs):
        s = torch.sum(xs)
        return s.item()   # tmlint: disable=torch-host-sync
"""

SUPPRESSED_PREV_LINE = """
    import torch

    def count(xs):
        s = torch.sum(xs)
        # tmlint: disable=torch-host-sync
        return s.item()
"""


def write_hot(tmp_path, src, name="mod.py"):
    d = tmp_path / "ops"
    d.mkdir(exist_ok=True)
    (d / name).write_text(textwrap.dedent(src))
    return tmp_path


def test_inline_suppression_same_line(tmp_path):
    root = write_hot(tmp_path, SUPPRESSED)
    res = lint_paths([str(root)], root=str(root))
    assert res.findings == []
    assert res.suppressed == 1


def test_suppression_comment_covers_next_line(tmp_path):
    root = write_hot(tmp_path, SUPPRESSED_PREV_LINE)
    res = lint_paths([str(root)], root=str(root))
    assert res.findings == []
    assert res.suppressed == 1


def test_suppression_of_other_rule_does_not_silence(tmp_path):
    root = write_hot(tmp_path, SUPPRESSED.replace(
        "torch-host-sync", "span-category"))
    res = lint_paths([str(root)], root=str(root))
    assert [f.rule for f in res.findings] == ["torch-host-sync"]


def test_baselined_finding_not_fresh_but_new_one_is(tmp_path):
    root = write_hot(tmp_path, VIOLATION)
    res = lint_paths([str(root)], root=str(root))
    assert len(res.findings) == 1
    bl = tmp_path / "baseline.json"
    save_baseline(res.findings, str(bl))
    baseline = load_baseline(str(bl))
    assert res.fresh(baseline) == []

    # same violation moved to a new function = a fresh finding
    write_hot(tmp_path, VIOLATION.replace("def count", "def tally"),
              name="mod2.py")
    res2 = lint_paths([str(root)], root=str(root))
    fresh = res2.fresh(baseline)
    assert len(res2.findings) == 2
    assert [f.symbol for f in fresh] == ["tally"]


def test_fingerprint_stable_across_line_shift():
    a = Finding(rule="r", path="p.py", line=10, col=0,
                message="m", symbol="C.f")
    b = Finding(rule="r", path="p.py", line=99, col=4,
                message="m", symbol="C.f")
    c = Finding(rule="r", path="p.py", line=10, col=0,
                message="m", symbol="C.g")
    assert a.fingerprint == b.fingerprint
    assert a.fingerprint != c.fingerprint
    # the JAX package's fingerprint, so a baseline reads in both
    assert a.fingerprint == JFinding(rule="r", path="p.py", line=1, col=0,
                                     message="m", symbol="C.f").fingerprint


def test_cli_json_round_trip_and_exit_codes(tmp_path, capsys):
    root = write_hot(tmp_path, VIOLATION)
    bl = tmp_path / "baseline.json"

    rc = cli_main(["lint", "--json", "--baseline", str(bl), str(root)])
    doc = json.loads(capsys.readouterr().out)
    assert rc == 1
    assert doc["schema"] == "tmlint/1"
    assert doc["fresh_count"] == 1
    (f,) = doc["findings"]
    assert f["rule"] == "torch-host-sync" and f["baselined"] is False
    # the document round-trips through both packages' Finding codecs
    assert Finding.from_dict(f).fingerprint == f["fingerprint"]
    assert JFinding.from_dict(f).fingerprint == f["fingerprint"]

    rc = cli_main(["lint", "--update-baseline", "--baseline", str(bl),
                   str(root)])
    capsys.readouterr()
    assert rc == 0 and bl.exists()

    rc = cli_main(["lint", "--json", "--baseline", str(bl), str(root)])
    doc = json.loads(capsys.readouterr().out)
    assert rc == 0
    assert doc["fresh_count"] == 0
    assert doc["findings"][0]["baselined"] is True


def test_cli_missing_path_exits_2(tmp_path, capsys):
    rc = cli_main(["lint", str(tmp_path / "nope")])
    capsys.readouterr()
    assert rc == 2


def test_cli_rules_subset(tmp_path, capsys):
    root = write_hot(tmp_path, VIOLATION)
    rc = cli_main(["lint", "--json", "--rules", "span-category",
                   "--baseline", str(tmp_path / "bl.json"), str(root)])
    doc = json.loads(capsys.readouterr().out)
    assert rc == 0 and doc["findings"] == []


def test_cli_list_rules(capsys):
    assert cli_main(["lint", "--list-rules"]) == 0
    names = [ln.split()[0] for ln in capsys.readouterr().out.splitlines()]
    assert "torch-host-sync" in names and "jax-host-sync" not in names
