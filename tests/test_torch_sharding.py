"""The port's multi-device crypto plane (`parallel/sharding.py`, kernel
K6's plain version on the CPU, `CudaBackend`'s mesh route) against the
JAX package's `parallel.sharding` jits and `TpuBackend`'s mesh route.

The JAX side runs on the conftest's 8-device virtual CPU mesh at
`__graft_entry__.dryrun_multichip`'s shapes (8 blocks x 2 validators x
128 B, 4 leaves x 16 B per block) and at `test_ed25519_grouped.py`'s mesh
shape (16 lanes, 4 keys, 96 B); the port's side on `Mesh([cpu] * n)`, a
virtual mesh whose shards run one after another.  Every comparison is
exact.  The JAX functions tally in int32 (x64 is off there) and wrap above
2^31 - 1; the port tallies in int64, so the JAX comparisons keep sums small
and the int64 cases are checked against numpy.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tendermint_tpu.crypto import backend as jbackend
from tendermint_tpu.ops import ed25519 as jed
from tendermint_tpu.parallel import sharding as jsharding
from tendermint_tpu_torch.crypto import pure_ed25519 as ref
from tendermint_tpu_torch.crypto.backend import CudaBackend
from tendermint_tpu_torch.ops import ed25519 as ed
from tendermint_tpu_torch.ops import kernels
from tendermint_tpu_torch.parallel import sharding
from test_torch_verify_raw import _arrays, edge_lanes

B, V, MSG_LEN, T, L = 8, 2, 128, 4, 16      # dryrun_multichip's shapes
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _share_cores():
    """A worker's share of the cores for torch (xdist runs several files
    at once, and several torch pools on the same cores run ~20x
    slower)."""
    n = torch.get_num_threads()
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def grid():
    """B blocks x V validators of signed 128-byte sign-bytes, with block 1
    holding a forged lane of nonzero power (not ok), block 5 a forged lane
    of power 0 (stays ok) and block 6 under quorum (valid lanes, the big
    validator's power 0 there); leaves [B, T, L]."""
    seeds = [bytes([90 + v]) * 32 for v in range(V)]
    pubs = np.stack([np.frombuffer(ref.pubkey_from_seed(s), np.uint8)
                     for s in seeds])
    rng = np.random.default_rng(41)
    msgs = rng.integers(0, 256, (B, V, MSG_LEN), dtype=np.uint8)
    sigs = np.stack([[np.frombuffer(ref.sign(seeds[v], msgs[b, v].tobytes()),
                                    np.uint8) for v in range(V)]
                     for b in range(B)])
    powers = np.tile(np.array([1, 10], np.int64), (B, 1))
    sigs[1, 1, 40] ^= 0x01                  # forged, power 10
    sigs[5, 0, 3] ^= 0x01                   # forged, power 0 below
    powers[5, 0] = 0
    powers[6, 1] = 0                        # tally 1 of 11: under quorum
    leaves = (np.arange(B * T * L) % 251).astype(np.uint8).reshape(B, T, L)
    ok = np.ones((B, V), bool)
    ok[1, 1] = ok[5, 0] = False
    return {"pubs": np.broadcast_to(pubs, (B, V, 32)).copy(), "msgs": msgs,
            "sigs": sigs, "powers": powers, "leaves": leaves,
            "total": int(powers[0].sum()), "ok": ok}


@pytest.fixture(scope="module")
def jax_mesh_outputs(grid):
    """The JAX sharded jits on the 8-device CPU mesh: sharded_verify_fn
    over the flattened grid, training_step_fn and sharded_merkle_fn."""
    mesh = jsharding.make_mesh(8, platform="cpu")
    flat = [grid[k].reshape(B * V, -1) for k in ("pubs", "msgs", "sigs")]
    verify = jsharding.sharded_verify_fn(mesh, MSG_LEN)
    ok, tallied = verify(*flat, grid["powers"].reshape(-1))
    step = jsharding.training_step_fn(mesh, MSG_LEN)(
        grid["pubs"], grid["msgs"], grid["sigs"], grid["powers"],
        grid["leaves"], np.asarray(grid["total"], np.int64))
    roots = jsharding.sharded_merkle_fn(mesh)(grid["leaves"])
    return {"verify": (np.asarray(ok), int(tallied)),
            "step": tuple(np.asarray(x) for x in step),
            "roots": np.asarray(roots), "verify_fn": verify}


def _t(a):
    return torch.tensor(np.ascontiguousarray(a))


# -- (a) K6's plain version and the single-device verify_tally -----------

def test_verify_tally_matches_reference_on_edge_lanes():
    """16 lanes x 96 B (the edge lanes, then valid repeats) with mixed
    powers: the port's `verify_tally_plain`, `ed25519.verify_tally` (one
    row and a 4-row grid) and `sharding.verify_tally` give JAX
    `verify_batch`'s mask and numpy's int64 tallies and quorums."""
    lanes = edge_lanes(96, np.random.default_rng(31))
    lanes += [lanes[0], lanes[11], lanes[10], lanes[5]]
    pubs, msgs, sigs = _arrays(lanes)
    want = np.asarray(jed.verify_batch(jnp.asarray(pubs), jnp.asarray(msgs),
                                       jnp.asarray(sigs)))
    assert want.tolist() == [ref.verify(*x) for x in lanes]
    powers = np.array([3, 0, 7, 1, 0, 2, 9, 4, 0, 0, 5, 6, 8, 0, 1, 2],
                      np.int64)
    base = ed.base_table(CPU)
    kernels.reset_launches()
    args = tuple(map(_t, (pubs, msgs, sigs, powers)))
    for rows in (1, 4):
        total = 7 * rows
        ok, tallied, block_ok = ed.verify_tally_plain(*args, rows, total,
                                                      base)
        got = ed.verify_tally(*args, rows, total, base)
        for g, p in zip(got, (ok, tallied, block_ok)):
            assert torch.equal(g, p)
        assert ok.tolist() == want.tolist()
        w_ok, w_pw = want.reshape(rows, -1), powers.reshape(rows, -1)
        w_tally = np.where(w_ok, w_pw, 0).sum(-1, dtype=np.int64)
        w_block = (w_ok | (w_pw == 0)).all(-1) & (w_tally * 3 > total * 2)
        assert tallied.tolist() == w_tally.tolist()
        assert block_ok.tolist() == w_block.tolist()
    ok, tallied = sharding.verify_tally(*args, base)
    assert ok.tolist() == want.tolist()
    assert tallied.dtype == torch.int64 and tallied.dim() == 0
    assert int(tallied) == int(np.where(want, powers, 0).sum())
    assert kernels.LAUNCHES["verify_tally"] == 0          # plain on CPU


# -- (b) the mesh functions against the JAX jits -------------------------

@pytest.mark.parametrize("shards", [1, 4])
def test_sharded_verify_fn_matches_jax(grid, jax_mesh_outputs, shards):
    mesh = sharding.Mesh([CPU] * shards)
    flat = [grid[k].reshape(B * V, -1) for k in ("pubs", "msgs", "sigs")]
    ok, tallied = sharding.sharded_verify_fn(mesh, MSG_LEN)(
        *flat, grid["powers"].reshape(-1))
    w_ok, w_tally = jax_mesh_outputs["verify"]
    assert ok.tolist() == w_ok.tolist() == grid["ok"].ravel().tolist()
    assert tallied.dtype == torch.int64 and int(tallied) == w_tally


@pytest.mark.parametrize("shards", [1, 4])
def test_training_step_fn_matches_jax(grid, jax_mesh_outputs, shards):
    mesh = sharding.Mesh([CPU] * shards)
    block_ok, tallied, roots = sharding.training_step_fn(mesh, MSG_LEN)(
        grid["pubs"], grid["msgs"], grid["sigs"], grid["powers"],
        grid["leaves"], grid["total"])
    w_ok, w_tally, w_roots = jax_mesh_outputs["step"]
    assert block_ok.tolist() == w_ok.tolist()
    assert tallied.dtype == torch.int64
    assert tallied.tolist() == w_tally.tolist()
    assert np.array_equal(roots.numpy(), w_roots)
    # blocks 1 (forged, power 10) and 6 (under quorum) fail; block 5's
    # forged lane has power 0 and it stays ok
    assert block_ok.tolist() == [b not in (1, 6) for b in range(B)]
    assert tallied.tolist()[5:7] == [10, 1]


def test_sharded_merkle_fn_matches_jax(grid, jax_mesh_outputs):
    for shards in (1, 2, 8):
        roots = sharding.sharded_merkle_fn(sharding.Mesh([CPU] * shards))(
            grid["leaves"])
        assert np.array_equal(roots.numpy(), jax_mesh_outputs["roots"])


# -- (c) CudaBackend's mesh route against TpuBackend's --------------------

GV, GN, GMSG = 4, 16, 96                    # test_ed25519_grouped's shape


@pytest.fixture(scope="module")
def grouped_lanes():
    seeds = [bytes([110 + v]) * 32 for v in range(GV)]
    vp = np.stack([np.frombuffer(ref.pubkey_from_seed(s), np.uint8)
                   for s in seeds])
    rng = np.random.default_rng(43)
    templates = rng.integers(0, 256, (3, GMSG), dtype=np.uint8)
    tmpl_idx = np.asarray([0, 0, 1, 2, 2, 2, 0, 1] * 2, np.int32)
    idx = (np.arange(GN) % GV).astype(np.int32)
    sigs = np.stack([np.frombuffer(
        ref.sign(seeds[idx[i]], templates[tmpl_idx[i]].tobytes()), np.uint8)
        for i in range(GN)])
    sigs[4] = sigs[5]                       # another key's signature
    sigs[9, 40] ^= 0x10                     # s bit
    return vp, idx, tmpl_idx, templates, sigs


def test_backend_mesh_route_matches_jax(grouped_lanes, monkeypatch):
    """16 lanes over 8 virtual CPU shards (MIN_LANES_PER_DEVICE = 2 on
    both sides): `CudaBackend.verify_grouped` and
    `verify_grouped_templated` take the mesh route (one K1 call per shard,
    the templated one keeping its templated lanes) and agree with
    `TpuBackend`'s mesh route and the golden verifier."""
    vp, idx, tmpl_idx, templates, sigs = grouped_lanes
    msgs = templates[tmpl_idx]
    jbe = jbackend.TpuBackend()
    assert len(jax.devices()) == 8 and jbe._mesh.devices.size == 8
    jbe.MIN_LANES_PER_DEVICE = 2
    want = jbe.verify_grouped(b"mesh-set", vp, idx, msgs, sigs)
    want_t = jbe.verify_grouped_templated(b"mesh-set", vp, idx, tmpl_idx,
                                          templates, sigs)
    golden = [ref.verify(vp[v].tobytes(), msgs[i].tobytes(),
                         sigs[i].tobytes()) for i, v in enumerate(idx)]
    assert want.tolist() == want_t.tolist() == golden
    assert not golden[4] and not golden[9] and sum(golden) == GN - 2

    mesh = sharding.Mesh([CPU] * 8)
    be = CudaBackend(device="cpu", mesh=mesh)
    be.MIN_LANES_PER_DEVICE = 2
    jtbl, jok = jbe._tables[b"mesh-set"][:2]
    be.tables_from_numpy(b"mesh-set", vp, np.asarray(jtbl), np.asarray(jok))
    calls = {"verify_grouped": [], "verify_grouped_templated": []}

    def counting(name):
        kernel = getattr(ed, name)

        def counted(*args):
            calls[name].append(args[-2].shape[0])   # sigs: lanes
            return kernel(*args)
        return counted

    for name in calls:
        monkeypatch.setattr(sharding._ed, name, counting(name))
    got = be.verify_grouped(b"mesh-set", vp, idx, msgs, sigs)
    # one K1 call per shard
    assert calls == {"verify_grouped": [2] * 8, "verify_grouped_templated": []}
    got_t = be.verify_grouped_templated(b"mesh-set", vp, idx, tmpl_idx,
                                        templates, sigs)
    assert calls == {"verify_grouped": [2] * 8,
                     "verify_grouped_templated": [2] * 8}
    assert got.tolist() == got_t.tolist() == want.tolist()
    # below the threshold the single-device path runs, with the same result
    be.MIN_LANES_PER_DEVICE = 4
    assert be.verify_grouped(b"mesh-set", vp, idx, msgs,
                             sigs).tolist() == golden
    assert be.verify_grouped_templated(b"mesh-set", vp, idx, tmpl_idx,
                                       templates, sigs).tolist() == golden
    # one K1 call each, on one device
    assert calls == {"verify_grouped": [2] * 8 + [16],
                     "verify_grouped_templated": [2] * 8 + [16]}


def test_backend_replicates_tables_once_per_device():
    """Eight virtual shards of one device share the one copy of the comb
    tables and of the base table; a distinct device gets its own."""
    be = CudaBackend(device="cpu", mesh=sharding.Mesh([CPU] * 8))
    z = np.zeros
    be.tables_from_numpy(b"s", z((2, 32), np.uint8),
                         z((26, 1024, 2, 3, 32), np.uint8), z(2, bool))
    tbl, ok, _, vp = be.tables(b"s", z((2, 32), np.uint8))
    for reps, t in zip(be._replicas[b"s"], (tbl, ok, vp)):
        assert len(reps) == 8 and all(r is t for r in reps)
    assert all(b is be._base for b in be._base_mesh)
    # eviction drops the replicas with the entry
    be.TABLE_CACHE_BYTES = tbl.numel()
    be.tables_from_numpy(b"t", z((2, 32), np.uint8),
                         z((26, 1024, 2, 3, 32), np.uint8), z(2, bool))
    assert set(be._tables) == set(be._replicas) == {b"t"}
    reps = sharding.replicate(
        sharding.Mesh([CPU, "meta", CPU, "meta"]), torch.ones(3))
    assert reps[0] is reps[2] and reps[1] is reps[3]
    assert reps[1].device.type == "meta"


# -- (d) int64 tallies past 2^31, and the JAX package's int32 wrap -------

def test_tally_is_int64_past_2_31(grid, jax_mesh_outputs):
    """Valid lanes of powers 2^31 - 1 and 5: the port's tally is
    2,147,483,652 in int64 (numpy agrees); the JAX function's int32 tally
    wraps to -2,147,483,644.  A tally of 2^31 - 1 against a total of
    3,000,000,000: tally * 3 and total * 2 pass 2^31 and the int64 quorum
    holds, as in numpy."""
    flat = [grid[k].reshape(B * V, -1) for k in ("pubs", "msgs", "sigs")]
    powers = np.zeros(B * V, np.int64)
    powers[[0, 2]] = [2**31 - 1, 5]           # both lanes valid
    want = int(np.where(grid["ok"].ravel(), powers, 0).sum(dtype=np.int64))
    assert want == 2**31 + 4
    ok, tallied = sharding.sharded_verify_fn(sharding.Mesh([CPU] * 2),
                                             MSG_LEN)(*flat, powers)
    assert int(tallied) == want
    _, j_tally = jax_mesh_outputs["verify_fn"](*flat, powers)
    assert j_tally.dtype == jnp.int32 and int(j_tally) == -2147483644

    base = ed.base_table(CPU)
    pw = np.zeros((B, V), np.int64)
    pw[:, 0] = 2**31 - 1                      # lane 0 of every block valid
    pw[1, 1] = 2**40                          # forged: block 1 fails
    total = 3_000_000_000
    args = [_t(grid[k].reshape(B * V, -1)) for k in ("pubs", "msgs", "sigs")]
    _, tallied, block_ok = ed.verify_tally(*args, _t(pw.ravel()), B, total,
                                           base)
    w_tally = np.where(grid["ok"], pw, 0).sum(-1, dtype=np.int64)
    w_block = (grid["ok"] | (pw == 0)).all(-1) & (w_tally * 3 > total * 2)
    assert tallied.tolist() == w_tally.tolist()
    assert block_ok.tolist() == w_block.tolist()
    assert w_block.tolist() == [b not in (1, 5) for b in range(B)]


# -- (e) shapes and meshes that do not fit -------------------------------

def test_mesh_errors(grid):
    flat = [grid[k].reshape(B * V, -1) for k in ("pubs", "msgs", "sigs")]
    powers = grid["powers"].reshape(-1)
    with pytest.raises(ValueError, match="do not split"):
        sharding.sharded_verify_fn(sharding.Mesh([CPU] * 3), MSG_LEN)(
            *flat, powers)
    with pytest.raises(ValueError, match="do not split"):
        sharding.sharded_merkle_fn(sharding.Mesh([CPU] * 3))(grid["leaves"])
    with pytest.raises(ValueError, match="bytes"):
        sharding.sharded_verify_fn(sharding.Mesh([CPU]), 96)(*flat, powers)
    with pytest.raises(ValueError, match="do not split"):
        ed.verify_tally(*map(_t, flat), _t(powers), 3, 1,
                        ed.base_table(CPU))
    with pytest.raises(ValueError, match="one replica per shard"):
        sharding.sharded_grouped_verify_fn(sharding.Mesh([CPU] * 2))(
            (None,), (None, None), None, None, None, None, (None, None))
    with pytest.raises(ValueError, match="at least one device"):
        sharding.Mesh([])


def test_make_mesh_needs_the_cards():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(ValueError, match="cuda devices, have 0"):
        sharding.make_mesh()
    with pytest.raises(ValueError, match="need 4 cuda devices"):
        sharding.make_mesh(4)
    assert sharding.device_label("cpu") == "cpu:0"
