"""Nothing the harness runs loads JAX or the JAX package, whose name the
port's begins with: names are compared whole, before the first dot."""

import ast
import subprocess
import sys

from conftest import CHECKOUT
from bftbench import harness

OLD = {"bench", "bench_kernels", "chip_smoke"}


def imported(path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_no_harness_source_imports_jax_or_the_old_benchmarks():
    root = CHECKOUT / "bftbench"
    for path in root.rglob("*.py"):
        if "tests" in path.parts:
            continue
        names = imported(path)
        assert not names & (set(harness.FORBIDDEN) | OLD), path
        if "reference" in path.parts or "costs" in path.parts:
            assert "tendermint_tpu_torch" not in names, path


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = f"""
import sys
sys.path.insert(0, {str(CHECKOUT)!r})
from bftbench import harness
from bftbench.tests.conftest import TINY, tiny_run
for cell in TINY:
    assert tiny_run(cell, trace=True)["correct"]
import bftbench.run
print(harness.forbidden_modules())
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=CHECKOUT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_check_compares_whole_top_level_names(monkeypatch):
    import tendermint_tpu_torch  # noqa: F401
    assert "tendermint_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "tendermint_tpu.x", object())
    assert harness.forbidden_modules() == ["tendermint_tpu"]
