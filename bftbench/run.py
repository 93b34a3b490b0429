"""Run one cell of the benchmark of `tendermint_tpu_torch` on the card.

    python3 bftbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout.  Set-up finds the card (none, or fewer than
the cell takes: exit 2, no result), loads the kernel library (built under
`build/kernels/` of the checkout on the first run there), makes the
cell's inputs from the seed and runs one untimed pass; then the window of
`--seconds`; then the reference judges the window's outputs.  With
`--trace 0` the result carries the cell's end-to-end metrics, with
`--trace 1` its per-layer metrics, read from the flight recorder, the
harness's own spans and a `torch.profiler` trace of the window.  The
numbers compared, each beside its limit, end standard error and close
the last line of standard output, one JSON object:
{"correct", "attempted", "failed", "metrics", "device"[, "breakdown"],
"checks"}.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # fixed cache directories inside the checkout, should anything of the
    # program compile through torch or triton
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(CHECKOUT / "build" / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(CHECKOUT / "build" /
                                                  "triton"))
    sys.path.insert(0, str(CHECKOUT))
    from bftbench import harness
    bench = harness.Bench()
    if args.workload not in bench.cells():
        print(f"no cell {args.workload!r}; cells: {bench.cells()}",
              file=sys.stderr)
        return 2
    chips = bench.data("workloads", args.workload)["chips"]
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    try:
        import tendermint_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"the program is not in this checkout: {e}", file=sys.stderr)
        return 2
    out = harness.run(args.workload, args.seed, args.seconds,
                      bool(args.trace), t_start=T_START, bench=bench)
    found = harness.forbidden_modules()
    if found:
        print(f"loaded in this process: {found}", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
