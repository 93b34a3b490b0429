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
function's registers, stack and static shared memory from ptxas; per
tree, case and size the device time of each CUDA kernel one launch runs
(`torch.profiler`); per tree and kernel the cycles of one dependent step
in one warp of a field product, a quad doubling, a mod-L reduction, a
SHA-512 compression, a field inversion and a SHA-256 compression, built
with that kernel's settings, and the SM clock over the SHA-256 chain
(`chip_smoke.fe_mul_cycles`); and for K4 per tree and size the chain
bound, one row's dependent steps at those cycles and that clock (a step
is the staged route's round warp, the 64 rounds from scheduled words,
where the tree has that route, else a whole compression).

The redesigns of K2 and K3 were measured with

    python3 bench_kernels.py --kernel build_neg_comb:4,100,128 \\
        --kernel sign_grouped:256,65500 --kernel verify_grouped:65536 \\
        --kernel verify_raw:64,65536 --kernel verify_tally:1x100000 \\
        parent=build/parent change=.

and the redesigns of K1 and of the Merkle tree (K7; a tree whose library
has no `tm_merkle_roots` runs its own `ops/merkle.py`) with

    python3 bench_kernels.py --kernel verify_grouped:65536 \
        --kernel verify_grouped_lanes:128 \
        --kernel merkle_roots:2048x1024x64 parent=build/parent change=.

and the redesign of K4 (two warps per 32 rows of 64 KB, a copy ring
and a scheduled-word ring in shared memory) with

    python3 bench_kernels.py \
        --kernel sha256_prefixed:2048x65536,2097152x64 \
        --kernel merkle_roots:2048x1024x64 parent=build/parent change=.

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


SIGN_KEYS = 100                    # the replay's validator set


def signing_set(n: int, dev, rng) -> tuple:
    """SIGN_KEYS keys and n lanes as one fixture signing call lays them
    out (lane i: key i % SIGN_KEYS, template i // SIGN_KEYS, 128-byte
    templates) -> (seeds, device (a, prefixes, pubkeys, val_idx,
    tmpl_idx, templates), host templates, val_idx, tmpl_idx)."""
    import numpy as np
    import torch
    seeds, a, pre, pubs, _ = cs._keys(SIGN_KEYS)
    vi = (np.arange(n) % SIGN_KEYS).astype(np.int32)
    ti = (np.arange(n) // SIGN_KEYS).astype(np.int32)
    templates = rng.integers(0, 256, (int(ti[-1]) + 1, 128), dtype=np.uint8)
    dev_args = tuple(torch.as_tensor(x, device=dev)
                     for x in (a, pre, pubs, vi, ti, templates))
    return seeds, dev_args, templates, vi, ti


def case_build_neg_comb(size: str, dev, rng) -> tuple:
    """K2 over V valid keys (size "V")."""
    import torch
    from tendermint_tpu_torch.ops import ed25519 as ed
    from tendermint_tpu_torch.ops import kernels
    v = int(size)
    pubs = torch.as_tensor(cs._keys(v)[3], device=dev)

    def launch():
        tbl = torch.empty((26, 1024, v, 3, 32), dtype=torch.uint8,
                          device=dev)
        ok = torch.empty(v, dtype=torch.int32, device=dev)
        bases = torch.empty((26, v, 4, 10), dtype=torch.int32, device=dev)
        kernels.launch("build_neg_comb", pubs, v, tbl, ok, bases)
        return tbl, ok

    def check(outs):
        ptbl, pok = ed.build_neg_comb_plain(pubs)
        cs.require(torch.equal(outs[1] != 0, pok) and bool(pok.all()),
                   f"K2 {v}: ok mask != plain")
        cs.require(torch.equal(outs[0], ptbl), f"K2 {v}: tables != plain")
        return f"{v} keys, tables == plain"
    return launch, check


def case_sign_grouped(size: str, dev, rng) -> tuple:
    """K3 at N lanes (size "N") over SIGN_KEYS keys, laid out as a fixture
    signing call."""
    import torch
    from tendermint_tpu_torch.crypto import pure_ed25519 as ref
    from tendermint_tpu_torch.ops import ed25519 as ed
    from tendermint_tpu_torch.ops import kernels
    n = int(size)
    seeds, args, templates, vi, ti = signing_set(n, dev, rng)
    base = ed.base_table(dev)

    def launch():
        out = torch.empty((n, 64), dtype=torch.uint8, device=dev)
        kernels.launch("sign_grouped", *args[:3], SIGN_KEYS, *args[3:5],
                       args[5], args[5].shape[0], 128, base, out, n)
        return (out,)

    def check(outs):
        cs.require(torch.equal(outs[0], ed.sign_grouped_templated_plain(
            *args, base)), f"K3 {n}: != plain")
        host = outs[0].cpu().numpy()
        for i in sorted({0, n // 2, n - 1}):
            cs.require(host[i].tobytes() == ref.sign(
                seeds[vi[i]], templates[ti[i]].tobytes()),
                f"K3 {n}: lane {i} != pure_ed25519.sign")
        return "== plain, 3 lanes == pure_ed25519.sign"
    return launch, check


def case_verify_grouped(size: str, dev, rng) -> tuple:
    """Templated K1 at N lanes (size "N") as one replay window: SIGN_KEYS
    keys in tables padded to Vb 128 by copies of column 0, every 97th
    lane's s tampered."""
    import torch
    from tendermint_tpu_torch.ops import ed25519 as ed
    from tendermint_tpu_torch.ops import kernels
    n = int(size)
    _, args, _, _, _ = signing_set(n, dev, rng)
    base = ed.base_table(dev)
    sigs = ed.sign_grouped_templated_plain(*args, base)
    sigs[::97, 40] ^= 1
    pubs = args[2]
    vb = 128
    tbl, ok = ed.build_neg_comb_plain(pubs)
    tbl = torch.cat([tbl, tbl[:, :, :1].expand(-1, -1, vb - SIGN_KEYS, -1,
                                                -1)], dim=2).contiguous()
    ok = torch.cat([ok, ok[:1].expand(vb - SIGN_KEYS)])
    vpubs = torch.cat([pubs, pubs[:1].expand(vb - SIGN_KEYS, -1)])
    vi, ti, templates = args[3], args[4], args[5]

    def launch():
        out = torch.empty(n, dtype=torch.bool, device=dev)
        kernels.launch("verify_grouped", tbl, vb, ok, vpubs, vb, vi, vi,
                       templates, templates.shape[0], 128, ti, sigs, base,
                       out, n)
        return (out,)

    def check(outs):
        want = ed.verify_grouped_templated_plain(tbl, ok, vpubs, vi, ti,
                                                 templates, sigs, base)
        cs.require(torch.equal(outs[0], want), f"K1 {n}: != plain")
        tampered = torch.zeros(n, dtype=torch.bool, device=dev)
        tampered[::97] = True
        cs.require(torch.equal(outs[0], ~tampered),
                   f"K1 {n}: not exactly the untampered lanes valid")
        return f"== plain, {int(outs[0].sum())} of {n} valid"
    return launch, check


def case_verify_grouped_lanes(size: str, dev, rng) -> tuple:
    """K1 with per-lane keys and messages at N lanes (size "N"): the
    smoke's consensus vote burst (100 validators, Vb 128, 128-byte
    prevote sign-bytes, adversarial lanes), tiled to N lanes, on tables
    built by K2's plain version."""
    import torch
    from tendermint_tpu_torch.ops import ed25519 as ed
    from tendermint_tpu_torch.ops import kernels
    n = int(size)
    kernel, ed.build_neg_comb = ed.build_neg_comb, ed.build_neg_comb_plain
    try:
        (tbl, ok, vi, pk, msgs, sigs, base), golden = cs.vote_burst(dev)
    finally:
        ed.build_neg_comb = kernel
    reps = -(-n // len(golden))
    vi, pk, msgs, sigs = (x.repeat((reps,) + (1,) * (x.dim() - 1))[:n]
                          .contiguous() for x in (vi, pk, msgs, sigs))
    golden = (golden * reps)[:n]
    lanes = torch.arange(n, dtype=torch.int32, device=dev)

    def launch():
        out = torch.empty(n, dtype=torch.bool, device=dev)
        kernels.launch("verify_grouped", tbl, tbl.shape[2], ok, pk, n, lanes,
                       vi, msgs, n, msgs.shape[1], lanes, sigs, base, out, n)
        return (out,)

    def check(outs):
        cs.require(torch.equal(outs[0], ed.verify_grouped_plain(
            tbl, ok, vi, pk, msgs, sigs, base)), f"K1 lanes {n}: != plain")
        cs.require(outs[0].tolist() == golden,
                   f"K1 lanes {n}: != pure_ed25519")
        return f"== plain == golden, {sum(golden)} of {n} valid"
    return launch, check


def case_sha256_prefixed(size: str, dev, rng) -> tuple:
    """K4 over N messages of L bytes with prefix 0x00 (size "NxL"): Merkle
    leaves."""
    import hashlib
    import torch
    from tendermint_tpu_torch.ops import kernels
    from tendermint_tpu_torch.ops import sha256 as s256
    n, width = map(int, size.split("x"))
    g = torch.Generator(device=dev).manual_seed(int(rng.integers(2**31)))
    msgs = torch.randint(0, 256, (n, width), generator=g, device=dev,
                         dtype=torch.uint8)

    def launch():
        out = torch.empty((n, 32), dtype=torch.uint8, device=dev)
        kernels.launch("sha256_prefixed", msgs, width, 0, out, n)
        return (out,)

    def check(outs):
        cs.require(torch.equal(outs[0], s256.sha256_prefixed_plain(msgs, 0)),
                   f"K4 {size}: != plain")
        cs.require(outs[0][0].cpu().numpy().tobytes() == hashlib.sha256(
            b"\0" + msgs[0].cpu().numpy().tobytes()).digest(),
            f"K4 {size}: != hashlib")
        return "== plain, message 0 == hashlib"
    return launch, check


_tree_merkle: dict = {}


def tree_merkle(csrc: Path):
    """The `ops/merkle.py` of the tree whose kernels are `csrc`, loaded
    as a module of its own (its imports resolve to this tree's wrappers,
    which launch through the library swapped in)."""
    import importlib.util
    path = csrc.parent / "ops" / "merkle.py"
    if path not in _tree_merkle:
        spec = importlib.util.spec_from_file_location(
            f"merkle_{len(_tree_merkle)}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _tree_merkle[path] = mod
    return _tree_merkle[path]


def case_merkle_roots(size: str, dev, rng) -> tuple:
    """`merkle.roots` over T trees x n leaves x L bytes (size "TxnxL"):
    through K7 where the tree's library has it, else the tree's own
    `roots` (a parent's level loop over K4)."""
    import torch
    from tendermint_tpu_torch.ops import kernels
    from tendermint_tpu_torch.ops import merkle
    from tendermint_tpu_torch.types import merkle as host_merkle
    trees, n, width = map(int, size.split("x"))
    g = torch.Generator(device=dev).manual_seed(int(rng.integers(2**31)))
    data = torch.randint(0, 256, (trees, n, width), generator=g, device=dev,
                         dtype=torch.uint8)

    def launch():
        lib = kernels.library()
        if hasattr(lib, "tm_merkle_roots"):
            return (merkle.roots(data),)
        return (tree_merkle(lib.csrc).roots(data),)

    def check(outs):
        cs.require(torch.equal(outs[0], merkle.roots_plain(data)),
                   f"roots {size}: != plain")
        host = data[0].cpu().numpy()
        cs.require(outs[0][0].cpu().numpy().tobytes() == host_merkle.root(
            [host[i].tobytes() for i in range(n)]),
            f"roots {size}: tree 0 != host tree")
        return "== plain, tree 0 == host tree"
    return launch, check


CASES = {"verify_raw": case_verify_raw, "verify_tally": case_verify_tally,
         "build_neg_comb": case_build_neg_comb,
         "sign_grouped": case_sign_grouped,
         "verify_grouped": case_verify_grouped,
         "verify_grouped_lanes": case_verify_grouped_lanes,
         "merkle_roots": case_merkle_roots,
         "sha256_prefixed": case_sha256_prefixed}
# the CUDA sources a case needs built (`kernels.build(only=...)`), where
# they are not the case's name; a tree builds those it has (a parent of
# K7 runs `roots` on K4)
SOURCES = {"verify_grouped_lanes": ("verify_grouped",),
           "merkle_roots": ("merkle_roots", "sha256_prefixed")}


def kernel_split(launch, reps: int = 3) -> dict | str:
    """Device milliseconds per launch of each CUDA kernel that `launch`
    runs, from `torch.profiler` (a case may run several, e.g. K2's two
    phases)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CUDA])
    try:
        prof.start()
    except RuntimeError as e:              # setting up the profiler
        return f"not measured ({e})"
    for _ in range(reps):                  # a launch's error propagates
        launch()
    torch.cuda.synchronize()
    try:
        prof.stop()
        events = prof.key_averages()
    except RuntimeError as e:              # reading the profiler's trace
        return f"not measured ({e})"
    out = {}
    for e in events:
        us = getattr(e, "device_time_total", None)
        if us is None:
            us = getattr(e, "cuda_time_total", 0)
        if us and "kernel" in e.key:
            out[e.key.split("(")[0]] = us / 1e3 / e.count
    return out or "not measured (no device time in the trace)"


def ptxas(report: str) -> dict:
    """entry function (with its template argument, e.g. `f<16>`) ->
    registers, cumulative stack bytes and static shared memory bytes, from
    a `kernels.build` report."""
    out, fn = {}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '_Z(\d+)(\w+)'", line)
        if m:
            fn = m.group(2)[:int(m.group(1))]
            targ = re.match(r"ILi(\d+)E", m.group(2)[int(m.group(1)):])
            if targ:
                fn += f"<{targ.group(1)}>"
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            stack = re.search(r"(\d+) bytes cumulative stack", line)
            smem = re.search(r"(\d+) bytes smem", line)
            out[fn] = {"registers": int(m.group(1)),
                       "stack": int(stack.group(1)) if stack else 0,
                       "smem": int(smem.group(1)) if smem else 0}
            fn = None
    return out


def log_chain_bound(size: str, trees: list, results: dict) -> None:
    """K4's chain bound at `size` ("NxL") per tree: one row's dependent
    steps at the cycles and SM clock of that tree's microkernel, a step
    being the staged route's round warp where the tree has one, else a
    whole compression."""
    width = int(size.split("x")[1])
    blocks = (width + 1 + 9 + 63) // 64
    for t in trees:
        m = results[t["name"]]["micro"].get("sha256_prefixed") or {}
        step, what = m.get("sha256_rounds_cycles"), "round-warp steps"
        if not step:
            step, what = m.get("sha256_block_cycles"), "compressions"
        if step:
            chain = blocks * step / (m["sm_clock_mhz"] * 1e3)
            results[t["name"]].setdefault("chain_bound_ms", {})[size] = chain
            cs.log(f"[sha256_prefixed] {size}: {t['name']} chain bound "
                   f"{chain:.4f} ms ({blocks} {what} x {step:.1f} cycles "
                   f"at {m['sm_clock_mhz']:.0f} MHz)")


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
    only = sorted({src for name, _ in plan
                   for src in SOURCES.get(name, (name,))})
    trees = []
    for arg in args.trees:
        name, _, rest = arg.partition("=")
        path, _, flags = rest.partition(":")
        csrc = Path(path).resolve() / "tendermint_tpu_torch" / "csrc"
        trees.append({"name": name, "csrc": csrc,
                      "flags": [f for f in flags.split(",") if f],
                      "only": [k for k in only
                               if (csrc / f"{k}.cu").exists()]})

    card = cs.card_line()
    cs.log(card)
    with ThreadPoolExecutor(len(trees)) as pool:
        builds = list(pool.map(
            lambda t: kernels.build(t["csrc"], t["flags"], t["only"]),
            trees))
    for t, (so, report) in zip(trees, builds):
        t["lib"], t["ptxas"] = kernels.load(so), ptxas(report)
        t["lib"].csrc = t["csrc"]          # for a case's tree-own module
        cs.log(f"[build] {t['name']} ({t['csrc']}, flags {t['flags']}): "
               f"{t['ptxas']}")
    results = {t["name"]: {"ptxas": t["ptxas"], "micro": {}, "ms": {}}
               for t in trees}
    for t in trees:
        for name in t["only"]:
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
                del got
            for t in trees:
                with kernels.using(t["lib"]):
                    split = kernel_split(launch)
                results[t["name"]].setdefault("split", {})[key] = split
                cs.log(f"[{name}] {size}: {t['name']} per kernel: {split}")
            first = outs[trees[0]["name"]]
            what = check(first)
            for tree, got in outs.items():
                cs.require(all(torch.equal(a, b) for a, b in zip(got, first)),
                           f"{key}: {tree}'s outputs differ from "
                           f"{trees[0]['name']}'s")
            cs.log(f"[{name}] {size}: " + "; ".join(
                f"{t['name']} {results[t['name']]['ms'][key]}" for t in trees)
                + f" ms; outputs equal ({what})")
            if name == "sha256_prefixed":
                log_chain_bound(size, trees, results)
    cs.log(card)
    print(json.dumps({"card": card, "trees": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
