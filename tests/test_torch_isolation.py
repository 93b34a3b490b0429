"""The port stands alone: no module of `tendermint_tpu_torch` and none
of its scripts (`chip_smoke.py`, `bench_kernels.py`) imports JAX or the JAX package, and its entry points run on the card
unless the caller asks for the CPU."""

import ast
import pathlib

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "tendermint_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "bench_kernels.py"]
FORBIDDEN = ("jax", "tendermint_tpu")


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        elif isinstance(node, ast.Call):      # importlib / __import__
            names = [a.value for a in node.args
                     if isinstance(a, ast.Constant) and isinstance(a.value,
                                                                   str)]
            func = ast.unparse(node.func)
            if "import" not in func:
                names = []
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path.name}:{node.lineno} imports {bad}"


def test_port_files_found():
    names = {p.name for p in PORT_FILES}
    assert {"backend.py", "ed25519.py", "replay.py", "kernels.py",
            "store.py", "client.py", "db.py", "chip_smoke.py"} <= names
    rel = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    assert {"tendermint_tpu_torch/blockchain/store.py",
            "tendermint_tpu_torch/config.py",
            "tendermint_tpu_torch/consensus/height_vote_set.py",
            "tendermint_tpu_torch/consensus/messages.py",
            "tendermint_tpu_torch/consensus/replay.py",
            "tendermint_tpu_torch/consensus/state.py",
            "tendermint_tpu_torch/consensus/ticker.py",
            "tendermint_tpu_torch/consensus/wal.py",
            "tendermint_tpu_torch/state/txindex.py",
            "tendermint_tpu_torch/types/events.py",
            "tendermint_tpu_torch/types/priv_validator.py",
            "tendermint_tpu_torch/types/proposal.py",
            "tendermint_tpu_torch/types/vote.py",
            "tendermint_tpu_torch/utils/fmt.py",
            "tendermint_tpu_torch/light/client.py"} <= rel


def test_cuda_backend_needs_a_card():
    from tendermint_tpu_torch.crypto.backend import CudaBackend
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CudaBackend()
    assert CudaBackend(device="cpu").name == "cuda"


def test_every_entry_point_has_a_source():
    from tendermint_tpu_torch.ops import kernels
    sources = "".join(p.read_text() for p in kernels.CSRC.glob("*.cu"))
    for entry, kinds in kernels._ENTRY.values():
        assert f'extern "C" int {entry}(' in sources
        assert set(kinds) <= {"p", "i"}
    assert set(kernels.LAUNCHES) == set(kernels._ENTRY)
