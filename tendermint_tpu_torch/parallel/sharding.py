"""Multi-device crypto plane — the port of `tendermint_tpu/parallel/sharding.py`.

The JAX package shards the verification grid over a 1-D `jax.sharding.Mesh`
and lets XLA place the collectives.  Here a `Mesh` is an ordered tuple of
torch devices; every function splits its batch axis evenly over the mesh,
moves each shard's inputs to the shard's device, launches every shard's
kernels before it reads any result back (so distinct cards overlap), and
gathers the results on the mesh's first device — the counterpart of XLA's
gather, and of its psum for the voting-power tally.  Arguments the JAX
functions replicate (comb tables, `pub_ok`, the base table) are passed as
one tensor per shard (`replicate`), copied once per distinct device.

A mesh may name a device more than once: each repeat is a virtual shard,
run on the same card after the one before it.  That is the port's
counterpart of the JAX package's virtual CPU mesh
(`--xla_force_host_platform_device_count`): it exercises the split, not a
second card.

Kernels: `verify_tally`, `sharded_verify_fn` and `training_step_fn` run K6
(`ops/ed25519.verify_tally`, fused raw verify + per-row int64 tally +
quorum) per shard; `sharded_merkle_fn` runs `ops/merkle.roots` (K7),
`sharded_grouped_verify_fn` the single-device `verify_grouped` (K1) and
`sharded_grouped_templated_verify_fn` `verify_grouped_templated` (K1) per
shard.  The JAX module's utilization bookkeeping (`note_sharded_call`) is
not copied.
"""

from __future__ import annotations

import numpy as np
import torch

from tendermint_tpu_torch.ops import ed25519 as _ed
from tendermint_tpu_torch.ops import merkle as _merkle


def _device(d) -> torch.device:
    """`d` as a torch.device with its index filled in (cuda -> cuda:N of
    the current device), so equal devices compare equal."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


class Mesh:
    """A 1-D device mesh: `devices` in shard order (repeats allowed, each
    a virtual shard)."""

    def __init__(self, devices):
        self.devices = tuple(_device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def distinct(self) -> tuple:
        """The mesh's devices without repeats, in first-seen order."""
        return tuple(dict.fromkeys(self.devices))

    def __repr__(self) -> str:
        return f"Mesh({[device_label(d) for d in self.devices]})"


def device_label(d) -> str:
    d = torch.device(d)
    return f"{d.type}:{d.index or 0}"


def make_mesh(n_devices: int | None = None) -> Mesh:
    """1-D mesh over the first `n_devices` visible CUDA cards (default: all
    of them).  Raises when there are fewer, rather than silently using
    less; a virtual mesh repeats a device explicitly (`Mesh([dev] * n)`)."""
    have = torch.cuda.device_count()
    n = n_devices or have
    if n < 1 or have < n:
        raise ValueError(
            f"need {max(n, 1)} cuda devices, have {have} "
            f"(for virtual shards pass Mesh([device] * n))")
    return Mesh(torch.device("cuda", i) for i in range(n))


def replicate(mesh: Mesh, t) -> tuple:
    """One copy of `t` per shard, made once per distinct device (shards
    on one device share it)."""
    t = torch.as_tensor(t)
    copies = {d: t.to(d) for d in mesh.distinct}
    return tuple(copies[d] for d in mesh.devices)


def _split(mesh: Mesh, name: str, x) -> list:
    """`x` split evenly along its first axis, shard i on device i."""
    x = torch.tensor(x) if isinstance(x, np.ndarray) else x
    n = x.shape[0]
    if n % mesh.size:
        raise ValueError(f"{name}: {n} rows do not split over a "
                         f"{mesh.size}-shard mesh")
    c = n // mesh.size
    return [x[i * c:(i + 1) * c].to(d).contiguous()
            for i, d in enumerate(mesh.devices)]


def _gather(mesh: Mesh, parts: list) -> torch.Tensor:
    first = mesh.devices[0]
    return torch.cat([p.to(first) for p in parts])


def verify_tally(pubkeys, msgs, sigs, powers, base_tbl) -> tuple:
    """Batch-verify and tally the voting power of the valid lanes on one
    device (K6 with one row) -> (ok bool[N], tallied int64 scalar)."""
    ok, tallied, _ = _ed.verify_tally(pubkeys, msgs, sigs, powers, 1, 0,
                                      base_tbl)
    return ok, tallied[0]


def sharded_verify_fn(mesh: Mesh, msg_len: int):
    """`verify_tally` with the lanes split over `mesh`.

    Returns fn(pubkeys[N,32], msgs[N,msg_len], sigs[N,64], powers[N] int64)
    -> (ok[N] bool, tallied int64 scalar) on the mesh's first device; N
    must divide by the mesh size.  The shards' partial tallies are summed
    there in int64 (the JAX function's psum, which is int32 there).
    """
    base = replicate(mesh, _ed.base_table(mesh.devices[0]))

    def fn(pubkeys, msgs, sigs, powers):
        if msgs.shape[-1] != msg_len:
            raise ValueError(f"msgs: {msgs.shape[-1]} bytes, the function "
                             f"was made for {msg_len}")
        shards = zip(*(_split(mesh, name, x) for name, x in (
            ("pubkeys", pubkeys), ("msgs", msgs), ("sigs", sigs),
            ("powers", powers))))
        outs = [verify_tally(*shard, b) for shard, b in zip(shards, base)]
        ok = _gather(mesh, [o for o, _ in outs])
        tallied = _gather(mesh, [t.reshape(1) for _, t in outs])
        return ok, tallied.sum(dtype=torch.int64)

    return fn


def sharded_merkle_fn(mesh: Mesh):
    """Per-tree Merkle roots, trees split over `mesh`.

    fn(leaves[B, n, L]) -> roots[B, 32] on the mesh's first device, B
    divisible by the mesh size.
    """

    def fn(leaves):
        return _gather(mesh, [_merkle.roots(x)
                              for x in _split(mesh, "leaves", leaves)])

    return fn


def training_step_fn(mesh: Mesh, msg_len: int):
    """The framework's fused fast-sync replay step: verify a grid of
    commit signatures, tally power per block, check each block's quorum,
    and recompute the blocks' Merkle data roots.

    fn(pubkeys[B,V,32], msgs[B,V,msg_len], sigs[B,V,64], powers[B,V] int64,
       leaves[B,T,L], total_power)
      -> (block_ok[B] bool, tallied[B] int64, roots[B,32])
    with the block axis split over the mesh (B divisible by its size):
    each shard runs K6 over its rows and `roots` over its trees, and the
    results are gathered on the first device.  block_ok = every lane
    valid or of power 0, and tallied * 3 > total_power * 2, in int64.
    """
    base = replicate(mesh, _ed.base_table(mesh.devices[0]))

    def fn(pubkeys, msgs, sigs, powers, leaves, total_power):
        if msgs.shape[-1] != msg_len:
            raise ValueError(f"msgs: {msgs.shape[-1]} bytes, the function "
                             f"was made for {msg_len}")
        total = int(total_power)
        grids = [_split(mesh, name, x) for name, x in (
            ("pubkeys", pubkeys), ("msgs", msgs), ("sigs", sigs),
            ("powers", powers))]
        trees = _split(mesh, "leaves", leaves)
        outs = []
        for (p, m, s, w), tr, b in zip(zip(*grids), trees, base):
            rows = w.shape[0]
            _, tallied, block_ok = _ed.verify_tally(
                p.reshape(-1, 32), m.reshape(-1, msg_len),
                s.reshape(-1, 64), w.reshape(-1), rows, total, b)
            outs.append((block_ok, tallied, _merkle.roots(tr)))
        return tuple(_gather(mesh, list(col)) for col in zip(*outs))

    return fn


def _replicas(mesh: Mesh, **reps) -> tuple:
    """The replicated arguments, each checked to hold one tensor per
    shard."""
    for name, r in reps.items():
        if not isinstance(r, (tuple, list)) or len(r) != mesh.size:
            raise ValueError(f"{name} needs one replica per shard of a "
                             f"{mesh.size}-shard mesh (`replicate`)")
    return tuple(zip(*reps.values()))


def sharded_grouped_verify_fn(mesh: Mesh):
    """Grouped verify over a mesh: lanes split, comb tables replicated.

    fn(tables, pub_ok, val_idx[N], pubkeys[N,32], msgs[N,M], sigs[N,64],
       base_tbl) -> bool[N] on the mesh's first device.  `tables`,
    `pub_ok` and `base_tbl` come replicated, one tensor per shard
    (`replicate`), as the JAX function takes them already committed to
    the mesh; the lanes split evenly.
    Each shard runs the whole single-device `ops.ed25519.verify_grouped`
    (K1) on its lanes — as the JAX package's `shard_map` insists, since
    that function's batch inversion chains across lanes — with no
    communication until the gather.
    """

    def fn(tables, pub_ok, val_idx, pubkeys, msgs, sigs, base_tbl):
        reps = _replicas(mesh, tables=tables, pub_ok=pub_ok,
                         base_tbl=base_tbl)
        lanes = [_split(mesh, name, x) for name, x in (
            ("val_idx", val_idx), ("pubkeys", pubkeys), ("msgs", msgs),
            ("sigs", sigs))]
        return _gather(mesh, [
            _ed.verify_grouped(tbl, ok, vi, pk, m, s, b)
            for (tbl, ok, b), (vi, pk, m, s) in zip(reps, zip(*lanes))])

    return fn


def sharded_grouped_templated_verify_fn(mesh: Mesh):
    """`sharded_grouped_verify_fn` for templated lanes: each shard runs
    `ops.ed25519.verify_grouped_templated` (K1 gathering each lane's key
    and message on the device) on its share of the lanes.

    fn(tables, pub_ok, val_pubs[Vb,32], val_idx[N], tmpl_idx[N],
       templates[T,M], sigs[N,64], base_tbl) -> bool[N] on the mesh's
    first device.  `tables`, `pub_ok`, `val_pubs`, `templates` and
    `base_tbl` come replicated (`replicate`); val_idx, tmpl_idx and sigs
    split evenly.  The JAX package has no such function: its backend
    assembles a mesh batch's messages on the host and calls
    `sharded_grouped_verify_fn`, which ships M bytes per lane instead of
    a template index.
    """

    def fn(tables, pub_ok, val_pubs, val_idx, tmpl_idx, templates, sigs,
           base_tbl):
        reps = _replicas(mesh, tables=tables, pub_ok=pub_ok,
                         val_pubs=val_pubs, templates=templates,
                         base_tbl=base_tbl)
        lanes = [_split(mesh, name, x) for name, x in (
            ("val_idx", val_idx), ("tmpl_idx", tmpl_idx), ("sigs", sigs))]
        return _gather(mesh, [
            _ed.verify_grouped_templated(tbl, ok, vp, vi, ti, tm, s, b)
            for (tbl, ok, vp, tm, b), (vi, ti, s) in zip(reps,
                                                         zip(*lanes))])

    return fn
