"""The port's SHA-512, SHA-256 and Merkle twins against hashlib and the
host trees.

Digests and roots are compared byte for byte with `hashlib` and with the
host Merkle tree of both packages (`tendermint_tpu.types.merkle`, the tree
the JAX package's device roots are held against), at the padding edges
and tree shapes where the level schedule changes.  The static level
schedule `_plan(n)` must equal the JAX package's.
"""

import hashlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tendermint_tpu.ops import merkle as jax_merkle
from tendermint_tpu.types import merkle as jax_host_merkle
from tendermint_tpu_torch.ops import kernels, merkle, sha256, sha512
from tendermint_tpu_torch.types import merkle as host_merkle

RNG = np.random.default_rng(17)


def _msgs(n, length):
    return RNG.integers(0, 256, (n, length), dtype=np.uint8)


@pytest.mark.parametrize("length", [0, 111, 112, 127, 128, 192])
def test_sha512_padding_edges(length):
    m = _msgs(3, length)
    got = sha512.sha512(torch.as_tensor(m)).numpy()
    for i in range(3):
        assert got[i].tobytes() == hashlib.sha512(m[i].tobytes()).digest()


@pytest.mark.parametrize("length", [0, 55, 56, 63, 64, 111, 112, 127, 128,
                                    192])
def test_sha256_padding_edges(length):
    m = _msgs(3, length)
    got = sha256.sha256(torch.as_tensor(m)).numpy()
    for i in range(3):
        assert got[i].tobytes() == hashlib.sha256(m[i].tobytes()).digest()


def test_sha256_prefixed_cpu_is_plain():
    """On a CPU tensor the K4 wrapper runs the plain twin and launches
    nothing."""
    kernels.reset_launches()
    m = torch.as_tensor(_msgs(5, 65))
    got = sha256.sha256_prefixed(m, 0x01)
    assert torch.equal(got, sha256.sha256_prefixed_plain(m, 0x01))
    assert got[2].numpy().tobytes() == hashlib.sha256(
        b"\x01" + m[2].numpy().tobytes()).digest()
    assert all(n == 0 for n in kernels.LAUNCHES.values())
    with pytest.raises(TypeError):
        sha256.sha256_prefixed(m.to(torch.int32), 0)
    with pytest.raises(ValueError):
        sha256.sha256_prefixed(m, 256)


def test_leaf_hashes():
    data = _msgs(12, 64).reshape(3, 4, 64)
    got = merkle.leaf_hashes(torch.as_tensor(data)).numpy()
    for b in range(3):
        for i in range(4):
            assert got[b, i].tobytes() == host_merkle.leaf_hash(
                data[b, i].tobytes())


@pytest.mark.parametrize("n", [1, 2, 3, 5, 7, 64])
def test_roots_match_host_trees(n):
    data = RNG.integers(0, 256, (2, n, 24), dtype=np.uint8)
    got = merkle.roots(torch.as_tensor(data)).numpy()
    for b in range(2):
        items = [data[b, i].tobytes() for i in range(n)]
        assert got[b].tobytes() == host_merkle.root(items)
        assert got[b].tobytes() == jax_host_merkle.root(items)
    # the level schedule is the reference's, step by step
    for (pairs, singles), (jpairs, jsingles) in zip(
            merkle._plan(n), jax_merkle._plan(n), strict=True):
        assert np.array_equal(pairs, jpairs)
        assert np.array_equal(singles, jsingles)


def test_root_from_leaf_hashes_empty_raises():
    with pytest.raises(ValueError):
        merkle.root_from_leaf_hashes(torch.zeros((1, 0, 32), dtype=torch.uint8))


def test_part_sets_device_gate_matches_host():
    """`from_data_batched` leaf-hashes full chunks through the "cuda"
    backend once a window has DEVICE_MIN_CHUNKS of them; the part sets
    (root, proofs) equal the host path's."""
    from tendermint_tpu_torch.crypto.backend import CudaBackend, PythonBackend
    from tendermint_tpu_torch.types import part_set
    datas = [RNG.integers(0, 256, n, dtype=np.uint8).tobytes()
             for n in (64 * 9, 64 * 7 + 5, 64 * 3)]
    host = part_set.from_data_batched(datas, part_size=64,
                                      backend=PythonBackend())
    dev = part_set.from_data_batched(datas, part_size=64,
                                     backend=CudaBackend(device="cpu"))
    assert [p.header for p in dev] == [p.header for p in host]
    assert [p.get_part(1).proof for p in dev] == \
        [p.get_part(1).proof for p in host]
    assert all(p.get_part(i).verify(p.header)
               for p in dev for i in range(p.total))


def test_part_sets_record_their_steps():
    """`from_data_batched` marks chunking, the join, the device batch and
    the trees as `torch.profiler` spans, and gives the same part sets
    under the profiler."""
    from torch.profiler import ProfilerActivity, profile
    from tendermint_tpu_torch.crypto.backend import CudaBackend
    from tendermint_tpu_torch.types import part_set
    datas = [RNG.integers(0, 256, 64 * 20, dtype=np.uint8).tobytes()
             for _ in range(2)]
    be = CudaBackend(device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = part_set.from_data_batched(datas, part_size=64, backend=be)
    spans = {e.key for e in prof.key_averages()
             if e.key.startswith("part_set.")}
    assert spans == {"part_set.chunk", "part_set.join",
                     "part_set.leaf_hashes", "part_set.trees"}
    plain = part_set.from_data_batched(datas, part_size=64)
    assert [p.header for p in traced] == [p.header for p in plain]


def _walk_plan_table(leaf_hashes: list) -> bytes:
    """The root from `plan_table(n)` as K7 walks it: per level, m and k,
    the m pairs hashed as 0x01 || left || right and the k singles copied,
    into the other buffer."""
    n = len(leaf_hashes)
    table = merkle.plan_table(n)
    cur, pos = list(leaf_hashes), 0
    while pos < len(table):
        m, k = int(table[pos]), int(table[pos + 1])
        pairs = table[pos + 2:pos + 2 + 2 * m]
        singles = table[pos + 2 + 2 * m:pos + 2 + 2 * m + k]
        cur = [hashlib.sha256(b"\x01" + cur[pairs[2 * j]]
                              + cur[pairs[2 * j + 1]]).digest()
               for j in range(m)] + [cur[s] for s in singles]
        pos += 2 + 2 * m + k
    assert pos == len(table) and len(cur) == 1
    return cur[0]


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 6, 7, 8, 9, 64, 1000, 1024,
                               1025])
def test_plan_table_walk_gives_host_roots(n):
    """K7's flat schedule, walked with hashlib, gives the host trees'
    roots of both packages, and flattens the JAX package's `_plan(n)`
    step for step."""
    items = [RNG.integers(0, 256, 24, dtype=np.uint8).tobytes()
             for _ in range(n)]
    leaves = [host_merkle.leaf_hash(x) for x in items]
    root = _walk_plan_table(leaves)
    assert root == host_merkle.root(items) == jax_host_merkle.root(items)
    want = [np.zeros(0, np.int32)]
    for pairs, singles in jax_merkle._plan(n):
        want += [np.array([len(pairs), len(singles)]), pairs.reshape(-1),
                 singles]
    assert np.array_equal(merkle.plan_table(n), np.concatenate(want))
    assert merkle.plan_table(n).dtype == np.int32


@pytest.mark.parametrize("n", [3, 13, 100])
def test_roots_plain_match_jax_roots(n):
    """`roots_plain` against the JAX package's `roots` at the shapes of
    its own device Merkle test (4 trees x n leaves x 24 B)."""
    data = RNG.integers(0, 256, (4, n, 24), dtype=np.uint8)
    want = np.asarray(jax_merkle.roots(jnp.asarray(data)))
    assert np.array_equal(merkle.roots_plain(torch.as_tensor(data)).numpy(),
                          want)


def test_root_from_leaf_hashes_plain_matches_jax():
    """`root_from_leaf_hashes_plain` against the JAX package's at its
    test's shape (3 trees x 10 leaf hashes), and the wrapper on a CPU
    tensor runs it and launches nothing."""
    h = RNG.integers(0, 256, (3, 10, 32), dtype=np.uint8)
    want = np.asarray(jax_merkle.root_from_leaf_hashes(jnp.asarray(h)))
    t = torch.as_tensor(h)
    assert np.array_equal(merkle.root_from_leaf_hashes_plain(t).numpy(),
                          want)
    kernels.reset_launches()
    assert np.array_equal(merkle.root_from_leaf_hashes(t).numpy(), want)
    assert all(n == 0 for n in kernels.LAUNCHES.values())
    with pytest.raises(ValueError):
        merkle.root_from_leaf_hashes(t[..., :31])


@pytest.mark.parametrize("leaf_len", [0, 55, 56, 119])
def test_roots_leaf_lengths_and_batch_dims(leaf_len):
    """`roots` on a [2, 3, n, L] batch at the SHA-256 padding edges of a
    leaf (0x00 || leaf of 1, 56, 57 and 120 bytes) equals the host tree
    per tree, as `roots_plain`."""
    n = 5
    data = RNG.integers(0, 256, (2, 3, n, leaf_len), dtype=np.uint8)
    got = merkle.roots(torch.as_tensor(data)).numpy()
    assert got.shape == (2, 3, 32)
    for a in range(2):
        for b in range(3):
            assert got[a, b].tobytes() == host_merkle.root(
                [data[a, b, i].tobytes() for i in range(n)])
