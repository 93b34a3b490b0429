"""A cell, a configuration, a traffic mix and a per-layer metric are
added by new files alone: the harness finds them by name."""

import json
import shutil

from conftest import CHECKOUT, TINY, tiny_run
from bftbench import harness


def test_new_files_make_a_new_cell(tmp_path):
    root = tmp_path / "bftbench"
    shutil.copytree(CHECKOUT / "bftbench", root,
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    config = json.loads((root / "configs/v100-fastsync.json").read_text())
    config["validators"] = 7
    (root / "configs/v7-fastsync.json").write_text(json.dumps(config))
    (root / "traffic/sync_tx2k_x3.json").write_text(json.dumps(
        {"kind": "chain", "txs_per_block": 3, "tx_bytes": 2048,
         "blocks": 3, "tip_blocks": 1}))
    (root / "metrics/txs_per_pass.py").write_text(
        'UNIT = "txs"\n\n\ndef read(ctx):\n'
        '    return sum(p.height for p in ctx.records) * 3 / '
        'len(ctx.records)\n')
    (root / "workloads/fastsync.v7.tx2k.json").write_text(json.dumps({
        "config": "v7-fastsync", "traffic": "sync_tx2k_x3", "chips": 1,
        "why": "a test cell", "end_to_end": ["blocks_per_s", "setup_s"],
        "per_layer": ["txs_per_pass", "apply_ms_per_block"]}))
    bench = harness.Bench(root)
    assert "fastsync.v7.tx2k" in bench.cells()
    tiny = {"config": {"window": 3}, "traffic": {}}
    out = tiny_run("fastsync.v7.tx2k", trace=True, bench=bench,
                   overrides=tiny, seconds=1.0)
    assert out["correct"], out["checks"]
    assert out["metrics"]["txs_per_pass"]["unit"] == "txs"
    assert out["metrics"]["txs_per_pass"]["value"] > 0
    assert "apply_ms_per_block" in out["metrics"]
    assert set(TINY) <= set(bench.cells())
