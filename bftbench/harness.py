"""The benchmark's engine: finds a cell's files by name and runs it.

A cell is `workloads/<cell>.json`: its configuration, its traffic mix,
the chips it takes, why it exists, and the metrics it reports.  The
configuration is `configs/<config>.json` (the deployment's settings and
the `driver` that runs its path through the program, `drivers/<driver>.py`);
the mix is `traffic/<mix>.json` (parameters, and the `kind` of traffic,
whose generator is `traffic/<kind>.py`); each per-layer metric is read by
`metrics/<metric>.py`.  So a later cell, configuration, mix or metric is
new files.

A run: set up (the card, the kernel library, the inputs from the seed,
one untimed pass over every shape the window uses), then steps of the
driver until `seconds` have gone by, then the reference's judgement of
what the window produced.  `setup_s` runs from the process's start (the
caller's first clock reading) to the first timed step.
"""

from __future__ import annotations

import gc
import importlib.util
from contextlib import nullcontext
import json
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from bftbench.trace import DeviceTrace, breakdown, busy_s, recorder_spans

ROOT = Path(__file__).resolve().parent
SETUP = "setup_s"
FORBIDDEN = ("jax", "jaxlib", "flax", "tendermint_tpu")


class Bench:
    """The benchmark's files under `root`, found by name."""

    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self._modules: dict = {}

    def data(self, kind: str, name: str) -> dict:
        with open(self.root / kind / f"{name}.json") as f:
            return json.load(f)

    def module(self, kind: str, name: str):
        """`<root>/<kind>/<name>.py`, loaded by its path."""
        path = self.root / kind / f"{name}.py"
        mod = self._modules.get(path)
        if mod is None:
            key = "bftbench_" + "_".join(
                "".join(c if c.isalnum() else "_" for c in part)
                for part in (str(abs(hash(str(self.root)))), kind, name))
            spec = importlib.util.spec_from_file_location(key, path)
            mod = importlib.util.module_from_spec(spec)
            sys.modules[key] = mod
            spec.loader.exec_module(mod)
            self._modules[path] = mod
        return mod

    def cell(self, name: str, overrides: dict | None = None) -> "Cell":
        w = self.data("workloads", name)
        config = {**self.data("configs", w["config"]),
                  **(overrides or {}).get("config", {})}
        mix = {**self.data("traffic", w["traffic"]),
               **(overrides or {}).get("traffic", {})}
        return Cell(name, w, config, mix)

    def cells(self) -> list:
        return sorted(p.stem for p in (self.root / "workloads").glob("*.json"))


@dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    mix: dict


@dataclass
class Context:
    """What a per-layer metric's reader reads: the cell (its workload,
    configuration and mix), the inputs the traffic made, the driver's
    steps in the window, and the traced run's spans and device events."""
    cell: Cell
    traffic: object
    records: list                  # the driver's steps in the window
    t0: float                      # the window, perf_counter seconds
    t1: float
    host_spans: list = field(default_factory=list)   # the harness's
    spans: list = field(default_factory=list)        # the recorder's
    events: list = field(default_factory=list)       # the card's

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unread"


def forbidden_modules() -> list:
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def _counts() -> dict:
    """The registry's verify counters (signatures asked for and passed,
    the calls that carried them) and the kernels' launches: a sanity line
    on standard error, no metric."""
    from tendermint_tpu_torch.ops import kernels
    from tendermint_tpu_torch.utils.metrics import REGISTRY
    return {**{k: getattr(REGISTRY, k).value for k in (
        "sigs_requested", "sigs_verified", "verify_batches")},
        **{f"launches.{k}": v for k, v in kernels.LAUNCHES.items()}}


def _cuda_backend(device):
    from tendermint_tpu_torch.crypto.backend import CudaBackend
    return CudaBackend(device)


def run(name: str, seed: int, seconds: float, trace: bool, *,
        t_start: float, bench: Bench | None = None, device: str = "cuda",
        backend_factory=_cuda_backend, signer=None,
        overrides: dict | None = None) -> dict:
    """One run of cell `name`; returns the result line's object (with the
    checks last).  `backend_factory(device)` makes the program's backend
    and `signer` signs the inputs (default: the backend's signer);
    `overrides` replace settings of the configuration and the mix (the
    tests' small sizes)."""
    import torch
    from tendermint_tpu_torch.utils import tracing
    bench = bench or Bench()
    cell = bench.cell(name, overrides)
    driver_mod = bench.module("drivers", cell.config["driver"])
    on_card = torch.device(device).type == "cuda"
    if on_card:
        from tendermint_tpu_torch.ops import kernels
        kernels.library()
    backend = backend_factory(device)
    a = time.perf_counter()
    traffic = bench.module("traffic", cell.mix["kind"]).generate(
        seed, cell.mix, cell.config, device,
        signer or backend.sign_grouped_templated)
    inputs_s = time.perf_counter() - a
    driver = driver_mod.Driver(traffic, cell.config, backend)
    try:
        a = time.perf_counter()
        driver.warm()
        warm_s = time.perf_counter() - a
        gc.collect()
        gc.freeze()         # the inputs live all run: keep the GC off them
        tracing.RECORDER.clear()
        before = _counts()
        records = []
        with DeviceTrace() if trace else nullcontext() as dev:
            t0 = time.perf_counter()
            setup_s = t0 - t_start
            deadline = t0 + seconds
            while time.perf_counter() < deadline:
                records.append(driver.step(deadline))
            if on_card:
                torch.cuda.synchronize()
            t1 = time.perf_counter()
        peak = torch.cuda.max_memory_allocated() if on_card else 0
        print(f"set-up {setup_s:.3f} s: inputs made from the seed "
              f"{inputs_s:.3f} s, warm-up {warm_s:.3f} s; window counters: "
              + ", ".join(f"{k} {v - before[k]}"
                          for k, v in _counts().items()), file=sys.stderr)
        spans = tracing.RECORDER.snapshot()
        dropped = tracing.RECORDER.dropped
    finally:
        driver.close()
    ctx = Context(cell, traffic, records, t0, t1)
    if trace:
        if dropped:
            raise RuntimeError(f"the flight recorder dropped {dropped} "
                               f"spans of the window")
        ctx.spans = recorder_spans(spans)
        ctx.host_spans = driver.host_spans(records)
        ctx.events = dev.events
        metrics = {}
        for m in cell.workload["per_layer"]:
            mod = bench.module("metrics", m)
            value = mod.read(ctx)
            if value is not None:
                metrics[m] = {"value": value, "unit": mod.UNIT}
        traced = {"busy_s": busy_s(ctx.events, t0, t1), "window_s": t1 - t0}
        spread = breakdown(ctx.events, ctx.spans + ctx.host_spans, t0, t1)
    else:
        values = {**driver.end_to_end(records, t1 - t0), SETUP: setup_s}
        units = {**driver_mod.UNITS, SETUP: "s"}
        metrics = {m: {"value": values[m], "unit": units[m]}
                   for m in cell.workload["end_to_end"]}
    counts, attempted, failed = driver.judge(
        records, np.random.default_rng(seed))
    del driver, records, traffic, ctx
    device_info = {"platform": "gpu" if on_card else device,
                   "kind": (torch.cuda.get_device_name(0) if on_card
                            else device),
                   "count": cell.workload["chips"],
                   "memory_peak_bytes": int(peak),
                   "power_limit": power_limit() if on_card else "none"}
    out = {"correct": None, "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": device_info}
    if trace:
        device_info.update(traced)
        print(f"rooflines at the peaks of a card at 700 W; this card: "
              f"{device_info['power_limit']}", file=sys.stderr)
        out["breakdown"] = spread
    from bftbench.reference.judge import LIMITS
    checks = {k: {"value": int(v), "limit": LIMITS[k]}
              for k, v in counts.items()}
    out["correct"] = failed == 0 and all(
        c["value"] <= c["limit"] for c in checks.values())
    out["checks"] = checks
    return out

