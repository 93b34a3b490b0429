#!/usr/bin/env python3
"""Time kernels of two or more source trees against each other on one
card: how a kernel redesign is measured, parent against change in one
call.

    mkdir -p build/parent && git archive <parent> | tar -x -C build/parent
    python3 bench_kernels.py --kernel verify_raw:32,64,1024,4096,65536 \\
        --kernel verify_tally:1x100000,1000x100 \\
        parent=build/parent change=. change-inline=.:-DTM_FE_MUL_INLINE

Each `NAME=DIR[:FLAG,...]` names a tree.  `ops/kernels.py` builds the
named kernels from the tree's `tendermint_tpu_torch/csrc/` (`build`, with
the flags after its own) and loads the library (`load`), and every launch
goes through `kernels.launch` with that library swapped in (`using`): the
trees must share the current tree's C entry points (`kernels._ENTRY`).
Each `--kernel NAME:SIZE,...` names a kernel of `CASES` below and the
sizes to time it at.  Every tree runs on the same device tensors, in turns
(first to last, then last to first), each time a CUDA-event mean over
several launches.  Every tree's outputs must equal the first tree's, and
the first tree's a reference the case computes.  Also printed: each entry
function's registers and stack from ptxas and, per tree and kernel, the
cycles per dependent field product and per quad doubling in one warp,
built with that kernel's settings (`chip_smoke.fe_mul_cycles`).

A kernel not in `CASES` gets a case: a function from (size, device, rng)
to (launch, check), `launch` returning the outputs of one launch and
`check` holding the first tree's outputs against the reference.

Prints one JSON line last.  Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import json
import re
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import chip_smoke as cs

DISTINCT = 256                     # distinct signed lanes per message length
REPS = 10                          # launches per timing, after a warm-up


def signed_lanes(msg_len: int, rng) -> tuple:
    """DISTINCT (pubkey, msg, sig) rows signed by `pure_ed25519`: every
    fourth valid, the others with R, s or the message tampered in turn ->
    (uint8 arrays, golden verdicts)."""
    import numpy as np
    from tendermint_tpu_torch.crypto import pure_ed25519 as ref
    rows = []
    for i in range(DISTINCT):
        seed = rng.integers(0, 256, 32, dtype=np.uint8).tobytes()
        msg = bytearray(rng.integers(0, 256, msg_len, dtype=np.uint8))
        sig = bytearray(ref.sign(seed, bytes(msg)))
        kind = i % 4
        if kind == 1:
            sig[int(rng.integers(0, 32))] ^= 1 << int(rng.integers(0, 8))
        elif kind == 2:
            sig[32 + int(rng.integers(0, 31))] ^= 1 << int(rng.integers(0, 8))
        elif kind == 3:
            msg[int(rng.integers(0, msg_len))] ^= 1
        rows.append((ref.pubkey_from_seed(seed), bytes(msg), bytes(sig)))
    golden = [ref.verify(*r) for r in rows]
    arrays = tuple(np.frombuffer(b"".join(r[k] for r in rows),
                                 np.uint8).reshape(DISTINCT, -1)
                   for k in range(3))
    return arrays, golden


_lanes: dict = {}


def tiled_lanes(msg_len: int, n: int, dev, rng) -> tuple:
    """n lanes tiled from the DISTINCT signed rows of `msg_len` bytes ->
    (pubkeys, msgs, sigs on `dev`, golden verdicts as a list)."""
    import numpy as np
    import torch
    if msg_len not in _lanes:
        _lanes[msg_len] = signed_lanes(msg_len, rng)
    arrays, golden = _lanes[msg_len]
    reps = -(-n // DISTINCT)
    dev_arrays = tuple(torch.as_tensor(np.tile(a, (reps, 1))[:n].copy(),
                                       device=dev) for a in arrays)
    return (*dev_arrays, (golden * reps)[:n])


def case_verify_raw(size: str, dev, rng) -> tuple:
    """K5 at N lanes x 32 B (size "N")."""
    import torch
    from tendermint_tpu_torch.ops import ed25519 as ed
    from tendermint_tpu_torch.ops import kernels
    n = int(size)
    pk, msgs, sigs, golden = tiled_lanes(32, n, dev, rng)
    base = ed.base_table(dev)

    def launch():
        out = torch.empty(n, dtype=torch.bool, device=dev)
        kernels.launch("verify_raw", pk, msgs, 32, sigs, base, out, n)
        return (out,)

    def check(outs):
        cs.require(outs[0].tolist() == golden, f"K5 {n}: != pure_ed25519")
        return f"{sum(golden)} valid"
    return launch, check


def case_verify_tally(size: str, dev, rng) -> tuple:
    """K6 at R rows x V lanes x 128 B (size "RxV"), int64 powers below
    2^40 (a tenth 0), total power half the mean row's."""
    import numpy as np
    import torch
    from tendermint_tpu_torch.ops import ed25519 as ed
    from tendermint_tpu_torch.ops import kernels
    rows, per_row = map(int, size.split("x"))
    n = rows * per_row
    pk, msgs, sigs, golden = tiled_lanes(128, n, dev, rng)
    base = ed.base_table(dev)
    pw = rng.integers(0, 2**40, n).astype(np.int64)
    pw[rng.random(n) < 0.1] = 0
    pw = torch.as_tensor(pw, device=dev)
    total = torch.tensor([int(pw.sum()) // rows // 2], dtype=torch.int64,
                         device=dev)

    def launch():
        ok = torch.empty(n, dtype=torch.bool, device=dev)
        tallied = torch.zeros(rows, dtype=torch.int64, device=dev)
        counts = torch.zeros((2, rows), dtype=torch.int32, device=dev)
        block_ok = torch.empty(rows, dtype=torch.bool, device=dev)
        kernels.launch("verify_tally", pk, msgs, 128, sigs, pw, base, total,
                       rows, per_row, ok, tallied, counts[0], counts[1],
                       block_ok)
        return ok, tallied, block_ok

    def check(outs):
        ok, tallied, block_ok = outs
        cs.require(ok.tolist() == golden, f"K6 {size}: mask != pure_ed25519")
        grid_ok, grid_pw = ok.view(rows, per_row), pw.view(rows, per_row)
        tally = torch.where(grid_ok, grid_pw, 0).sum(-1)
        cs.require(torch.equal(tallied, tally),
                   f"K6 {size}: tallies != torch int64")
        quorum = (grid_ok | (grid_pw == 0)).all(-1) & (tally * 3 > total * 2)
        cs.require(torch.equal(block_ok, quorum),
                   f"K6 {size}: block_ok != torch")
        return f"{int(block_ok.sum())} rows pass"
    return launch, check


CASES = {"verify_raw": case_verify_raw, "verify_tally": case_verify_tally}


def ptxas(report: str) -> dict:
    """entry function -> registers and cumulative stack bytes, from a
    `kernels.build` report."""
    out, fn = {}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '_Z(\d+)(\w+)'", line)
        if m:
            fn = m.group(2)[:int(m.group(1))]
        m = re.search(r"Used (\d+) registers.*?(\d+) bytes cumulative stack",
                      line)
        if m and fn:
            out[fn] = {"registers": int(m.group(1)),
                       "stack": int(m.group(2))}
            fn = None
    return out


def main() -> int:
    import numpy as np
    import torch
    from tendermint_tpu_torch.ops import kernels
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--kernel", action="append", required=True,
                    metavar="NAME:SIZE,...")
    ap.add_argument("trees", nargs="+", metavar="NAME=DIR[:FLAG,...]")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_kernels: no CUDA device", file=sys.stderr)
        return 2
    plan = []
    for spec in args.kernel:
        name, _, sizes = spec.partition(":")
        if name not in CASES or not sizes:
            ap.error(f"--kernel {spec}: expected one of {sorted(CASES)} "
                     f"with sizes")
        plan.append((name, sizes.split(",")))
    only = [name for name, _ in plan]
    trees = []
    for arg in args.trees:
        name, _, rest = arg.partition("=")
        path, _, flags = rest.partition(":")
        csrc = Path(path).resolve() / "tendermint_tpu_torch" / "csrc"
        trees.append({"name": name, "csrc": csrc,
                      "flags": [f for f in flags.split(",") if f]})

    card = cs.card_line()
    cs.log(card)
    with ThreadPoolExecutor(len(trees)) as pool:
        builds = list(pool.map(
            lambda t: kernels.build(t["csrc"], t["flags"], only), trees))
    for t, (so, report) in zip(trees, builds):
        t["lib"], t["ptxas"] = kernels.load(so), ptxas(report)
        cs.log(f"[build] {t['name']} ({t['csrc']}, flags {t['flags']}): "
               f"{t['ptxas']}")
    results = {t["name"]: {"ptxas": t["ptxas"], "micro": {}, "ms": {}}
               for t in trees}
    for t in trees:
        for name in only:
            m = cs.fe_mul_cycles(t["csrc"], name, t["flags"])
            results[t["name"]]["micro"][name] = m
            cs.log(f"[micro] {t['name']} {name}'s build: {m} cycles in one "
                   f"warp")

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(cs.SEED)
    order = trees + trees[::-1]
    for name, sizes in plan:
        for size in sizes:
            launch, check = CASES[name](size, dev, rng)
            key = f"{name} {size}"
            outs = {}
            for t in order:
                with kernels.using(t["lib"]):
                    ms, got = cs.cuda_ms(launch, REPS)
                results[t["name"]]["ms"].setdefault(key, []).append(ms)
                outs[t["name"]] = tuple(x.clone() for x in got)
            first = outs[trees[0]["name"]]
            what = check(first)
            for tree, got in outs.items():
                cs.require(all(torch.equal(a, b) for a, b in zip(got, first)),
                           f"{key}: {tree}'s outputs differ from "
                           f"{trees[0]['name']}'s")
            cs.log(f"[{name}] {size}: " + "; ".join(
                f"{t['name']} {results[t['name']]['ms'][key]}" for t in trees)
                + f" ms; outputs equal ({what})")
    cs.log(card)
    print(json.dumps({"card": card, "trees": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
