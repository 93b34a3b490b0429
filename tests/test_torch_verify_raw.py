"""The port's raw-lane verify (kernel K5's plain version on the CPU) and
`CudaBackend`'s `verify_batch` / `verify_grouped` against the JAX
package's `ed25519.verify_batch` / `verify_grouped_jit` and the golden
bigint verifier.

The JAX jits run at the shapes the JAX package's own tests compile (16
lanes x 96-byte messages; 4 keys for the grouped tables), so the
persistent compile cache serves them.  Every comparison is exact.
"""

import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tendermint_tpu.ops import curve as jcurve
from tendermint_tpu.ops import ed25519 as jed
from tendermint_tpu.ops import scalar as jsc
from tendermint_tpu_torch.crypto import pure_ed25519 as ref
from tendermint_tpu_torch.crypto.backend import CudaBackend
from tendermint_tpu_torch.ops import curve
from tendermint_tpu_torch.ops import ed25519 as ed
from tendermint_tpu_torch.ops import kernels
from tendermint_tpu_torch.ops import scalar as sc

N, MSG_LEN, V = 16, 96, 4


@pytest.fixture(autouse=True, scope="module")
def _share_cores():
    """xdist runs several files at once: a worker's share of the cores for
    torch keeps the plain versions' wide tensor ops from oversubscribing
    them (several torch pools on the same cores run ~20x slower)."""
    n = torch.get_num_threads()
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
    yield
    torch.set_num_threads(n)


def edge_lanes(msg_len: int, rng) -> list:
    """(pubkey, msg, sig) triples: valid lanes, each single mutation,
    malleated s, non-canonical and undecodable encodings, and the
    cofactorless identity case the golden verifier accepts."""
    seeds = [rng.integers(0, 256, 32, dtype=np.uint8).tobytes()
             for _ in range(4)]
    pubs = [ref.pubkey_from_seed(x) for x in seeds]
    msgs = [rng.integers(0, 256, msg_len, dtype=np.uint8).tobytes()
            for _ in range(4)]
    sigs = [ref.sign(x, m) for x, m in zip(seeds, msgs)]

    def flip(b, i):
        return b[:i] + bytes([b[i] ^ 1]) + b[i + 1:]

    y = 2                                   # smallest y that is no point
    while ref.pt_decode(y.to_bytes(32, "little")) is not None:
        y += 1
    s_big = int.from_bytes(sigs[0][32:], "little") + ref.L
    ident = (1).to_bytes(32, "little")
    return [
        (pubs[0], msgs[0], sigs[0]),                          # valid
        (pubs[1], flip(msgs[1], 0), sigs[1]),                 # message bit
        (pubs[2], msgs[2], flip(sigs[2], 0)),                 # R bit
        (pubs[3], msgs[3], flip(sigs[3], 40)),                # s bit
        (pubs[1], msgs[0], sigs[0]),                          # wrong key
        (pubs[0], msgs[0], sigs[0][:32] + s_big.to_bytes(32, "little")),
        (pubs[1], msgs[1], ref.P.to_bytes(32, "little") + sigs[1][32:]),
        ((ref.P + 3).to_bytes(32, "little"), msgs[2], sigs[2]),  # A y >= p
        (y.to_bytes(32, "little"), msgs[3], sigs[3]),         # A no point
        (ident[:31] + b"\x80", msgs[0], sigs[0]),             # x = 0, sign
        (ident, msgs[1], ident + bytes(32)),                  # identity
        (pubs[2], msgs[2], sigs[2]),                          # valid
    ]


def _arrays(lanes):
    return tuple(np.frombuffer(b"".join(x[k] for x in lanes),
                               np.uint8).reshape(len(lanes), -1).copy()
                 for k in range(3))


def test_verify_batch_matches_reference_on_edge_lanes():
    """16 lanes x 96 B (the edge lanes, then valid repeats): the port's
    plain verify == JAX `verify_batch` == `pure_ed25519.verify`."""
    lanes = edge_lanes(MSG_LEN, np.random.default_rng(31))
    lanes += [lanes[0], lanes[11], lanes[10], lanes[5]]
    pubs, msgs, sigs = _arrays(lanes)
    want = np.asarray(jed.verify_batch(jnp.asarray(pubs), jnp.asarray(msgs),
                                       jnp.asarray(sigs)))
    golden = [ref.verify(*x) for x in lanes]
    kernels.reset_launches()
    t = torch.tensor
    got = ed.verify_batch(t(pubs), t(msgs), t(sigs), ed.base_table("cpu"))
    assert got.tolist() == want.tolist() == golden
    assert golden[:12] == [True] + [False] * 9 + [True, True]
    assert kernels.LAUNCHES["verify_raw"] == 0            # plain on CPU


def test_verify_batch_edge_lanes_32_byte_messages():
    """The mempool's message length (a 32-byte digest): plain == golden."""
    lanes = edge_lanes(32, np.random.default_rng(32))
    pubs, msgs, sigs = _arrays(lanes)
    got = ed.verify_batch(*(torch.tensor(a) for a in (pubs, msgs, sigs)),
                          ed.base_table("cpu"))
    assert got.tolist() == [ref.verify(*x) for x in lanes]


def test_verify_batch_checks_its_arguments():
    base = ed.base_table("cpu")
    z = torch.zeros
    with pytest.raises(ValueError):
        ed.verify_batch(z((2, 31), dtype=torch.uint8),
                        z((2, 32), dtype=torch.uint8),
                        z((2, 64), dtype=torch.uint8), base)
    with pytest.raises(ValueError):
        ed.verify_batch(z((2, 32), dtype=torch.uint8),
                        z((3, 32), dtype=torch.uint8),
                        z((2, 64), dtype=torch.uint8), base)
    with pytest.raises(TypeError):
        ed.verify_batch(z((2, 32), dtype=torch.int32),
                        z((2, 32), dtype=torch.uint8),
                        z((2, 64), dtype=torch.uint8), base)


def test_scalar_helpers_match_reference():
    """`nibbles` and `pt_select` against the JAX package's."""
    rng = np.random.default_rng(33)
    s = rng.integers(0, 256, (3, 32), dtype=np.uint8)
    assert np.array_equal(sc.nibbles(torch.tensor(s)).numpy(),
                          np.asarray(jsc.nibbles(jnp.asarray(s))))
    mask = np.array([True, False, True])
    q = tuple(rng.integers(0, 256, (3, 32)) for _ in range(4))
    r = tuple(rng.integers(0, 256, (3, 32)) for _ in range(4))
    got = curve.pt_select(torch.tensor(mask),
                          tuple(map(torch.tensor, q)),
                          tuple(map(torch.tensor, r)))
    want = jcurve.pt_select(jnp.asarray(mask), tuple(map(jnp.asarray, q)),
                            tuple(map(jnp.asarray, r)))
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("n,msg_len", [(1, 32), (16, 96), (17, 32)])
def test_backend_verify_batch_pads_and_trims(n, msg_len):
    """`CudaBackend(device="cpu").verify_batch` buckets N lanes to a power
    of two by repeating lane 0 and trims the result: every lane agrees
    with the golden verifier."""
    rng = np.random.default_rng(34 + n)
    edge = edge_lanes(msg_len, rng)
    lanes = [edge[(i * 5) % len(edge)] for i in range(n)]
    pubs, msgs, sigs = _arrays(lanes)
    got = CudaBackend(device="cpu").verify_batch(pubs, msgs, sigs)
    assert got.dtype == bool and got.shape == (n,)
    assert got.tolist() == [ref.verify(*x) for x in lanes]


def test_backend_verify_batch_empty():
    z = np.zeros
    out = CudaBackend(device="cpu").verify_batch(
        z((0, 32), np.uint8), z((0, 32), np.uint8), z((0, 64), np.uint8))
    assert out.shape == (0,)


@pytest.fixture(scope="module")
def keyset():
    seeds = [bytes([70 + i]) * 32 for i in range(V)]
    pubs = np.stack([np.frombuffer(ref.pubkey_from_seed(s), np.uint8)
                     for s in seeds])
    tbl, ok = jed.build_neg_comb_jit(jnp.asarray(pubs))
    return seeds, pubs, np.asarray(tbl), np.asarray(ok)


def test_backend_verify_grouped_matches_reference(keyset):
    """12 grouped lanes (valid and adversarial) through
    `CudaBackend.verify_grouped` (bucketed to 16) against JAX
    `verify_grouped_jit` on the same 16 lanes, and the golden verifier."""
    seeds, pubs, jtbl, jok = keyset
    rng = np.random.default_rng(35)
    idx = np.arange(N, dtype=np.int32) % V
    msgs = rng.integers(0, 256, (N, MSG_LEN), dtype=np.uint8)
    sigs = np.stack([np.frombuffer(ref.sign(seeds[v], msgs[i].tobytes()),
                                   np.uint8) for i, v in enumerate(idx)])
    sigs[2, 33] ^= 1                        # s bit
    sigs[5, :32] = np.frombuffer((2**255 - 19).to_bytes(32, "little"),
                                 np.uint8)  # R >= p
    msgs[6, 9] ^= 4                         # message bit
    sigs[9] = sigs[8]                       # another key's signature
    want = np.asarray(jed.verify_grouped_jit(
        jnp.asarray(jtbl), jnp.asarray(jok), jnp.asarray(idx),
        jnp.asarray(pubs[idx]), jnp.asarray(msgs), jnp.asarray(sigs)))
    golden = [ref.verify(pubs[v].tobytes(), msgs[i].tobytes(),
                         sigs[i].tobytes()) for i, v in enumerate(idx)]
    assert want.tolist() == golden
    be = CudaBackend(device="cpu")
    be.tables_from_numpy(b"grouped-set", pubs, jtbl, jok)
    got = be.verify_grouped(b"grouped-set", pubs, idx[:12], msgs[:12],
                            sigs[:12])
    assert got.tolist() == golden[:12]
    assert not got[[2, 5, 6, 9]].any() and got[[0, 1, 3, 4]].all()
    # a set key reused for a set of another size is refused
    with pytest.raises(ValueError, match="different set size"):
        be.verify_grouped(b"grouped-set", pubs[:3], idx[:2] % 3, msgs[:2],
                          sigs[:2])
    with pytest.raises(ValueError, match="out of range"):
        be.verify_grouped(b"grouped-set", pubs, idx + 1, msgs, sigs)
