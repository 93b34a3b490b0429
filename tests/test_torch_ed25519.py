"""The port's comb-table build and grouped verify (kernels K2 and K1,
their plain versions on the CPU) against the JAX package's
`build_neg_comb_jit` / `verify_grouped_jit` and the golden bigint
verifier, on valid and adversarial lanes.

The JAX jits run at the shapes the JAX package's own tests compile (4
keys, 16 lanes, 96-byte messages), so the persistent compile cache serves
them.  The key set holds one undecodable key: table bytes for it are
unspecified, so tables must agree on every valid key and the ok masks must
agree.  The JAX-built tables are carried into the port's backend with
`tables_from_numpy`, and both sides verify on the same tables.
"""

import hashlib
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tendermint_tpu.ops import ed25519 as jed
from tendermint_tpu_torch.crypto import pure_ed25519 as ref
from tendermint_tpu_torch.crypto.backend import CudaBackend
from tendermint_tpu_torch.ops import ed25519 as ed
from tendermint_tpu_torch.ops import kernels

V, N, MSG_LEN = 4, 16, 96
BAD = 2                                   # index of the undecodable key


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


@pytest.fixture(scope="module")
def keyset():
    seeds = [bytes([90 + i]) * 32 for i in range(V)]
    pubs = np.stack([np.frombuffer(ref.pubkey_from_seed(s), np.uint8)
                     for s in seeds])
    pubs[BAD] = np.frombuffer((2**255 - 1).to_bytes(32, "little"), np.uint8)
    tbl, ok = jed.build_neg_comb_jit(jnp.asarray(pubs))
    return seeds, pubs, np.asarray(tbl), np.asarray(ok)


@pytest.fixture(scope="module")
def backend(keyset):
    _, pubs, tbl, ok = keyset
    be = CudaBackend(device="cpu")
    digest = np.frombuffer(hashlib.sha256(pubs.tobytes()).digest(), np.uint8)
    be.tables_from_numpy(b"set", pubs, tbl, ok, pubs_sha256=digest)
    return be


def test_build_neg_comb_matches_reference(keyset):
    _, pubs, jtbl, jok = keyset
    kernels.reset_launches()
    tbl, ok = ed.build_neg_comb(torch.as_tensor(pubs))
    assert ok.tolist() == jok.tolist() == [i != BAD for i in range(V)]
    assert np.array_equal(tbl.numpy()[:, :, jok], jtbl[:, :, jok])
    assert all(n == 0 for n in kernels.LAUNCHES.values())   # plain on CPU


def test_tables_from_numpy_checks_the_digest(keyset, backend):
    _, pubs, tbl, ok = keyset
    with pytest.raises(ValueError):
        backend.tables_from_numpy(b"other", pubs, tbl, ok,
                                  pubs_sha256=np.zeros(32, np.uint8))
    with pytest.raises(ValueError):
        backend.tables_from_numpy(b"other", pubs, tbl[:, :, :2], ok[:2])
    assert backend.tables_cached(b"set") and not \
        backend.tables_cached(b"other")


def _lanes(seeds):
    """16 lanes: valid ones and the adversarial cases of the reference's
    grouped-verify test, with lane i signed by key i % V."""
    rng = np.random.default_rng(21)
    idx = np.arange(N, dtype=np.int32) % V
    msgs = rng.integers(0, 256, (N, MSG_LEN), dtype=np.uint8)
    sigs = [bytearray(ref.sign(seeds[v], msgs[i].tobytes()))
            for i, v in enumerate(idx)]
    s_int = int.from_bytes(bytes(sigs[1][32:]), "little")
    sigs[1][32:] = (s_int + ref.L).to_bytes(32, "little")      # s >= L
    sigs[5][:32] = (2**255 - 19).to_bytes(32, "little")        # R >= p
    msgs[3, 0] ^= 1                                            # message bit
    sigs[4] = bytearray(ref.sign(seeds[(idx[4] + 1) % V],
                                 msgs[4].tobytes()))           # wrong key
    sigs[7][5] ^= 0x10                                         # R bit
    sigs[9][45] ^= 0x10                                        # s bit
    sigs[13] = bytearray((1).to_bytes(32, "little") + bytes(32))  # R = 1
    return idx, msgs, np.frombuffer(b"".join(sigs),
                                    np.uint8).reshape(N, 64).copy()


def _golden(pubs, idx, msgs, sigs):
    return [bool(idx[i] != BAD) and ref.verify(
        pubs[idx[i]].tobytes(), msgs[i].tobytes(), sigs[i].tobytes())
        for i in range(len(idx))]


def test_verify_grouped_matches_reference(keyset):
    seeds, pubs, jtbl, jok = keyset
    idx, msgs, sigs = _lanes(seeds)
    want = np.asarray(jed.verify_grouped_jit(
        jnp.asarray(jtbl), jnp.asarray(jok), jnp.asarray(idx),
        jnp.asarray(pubs[idx]), jnp.asarray(msgs), jnp.asarray(sigs)))
    t = torch.tensor
    got = ed.verify_grouped(t(jtbl), t(jok), t(idx), t(pubs[idx]), t(msgs),
                            t(sigs), ed.base_table("cpu")).numpy()
    assert got.tolist() == want.tolist() == _golden(pubs, idx, msgs, sigs)
    assert got[[0, 8, 12]].all()                  # valid lanes of key 0
    assert not got[[1, 3, 4, 5, 7, 9, 13]].any()  # adversarial lanes
    assert not got[idx == BAD].any()              # the undecodable key


def test_verify_grouped_templated_matches_reference(keyset, backend):
    """Templated lanes (3 templates, uneven sharing) through the backend,
    12 lanes bucketed to 16 by repeating lane 0.  The reference's
    templated kernel is its plain kernel on the gathered lanes
    (`verify_grouped_templated` = take + `verify_grouped`), which is the
    compiled shape compared here."""
    seeds, pubs, jtbl, jok = keyset
    rng = np.random.default_rng(22)
    templates = rng.integers(0, 256, (3, MSG_LEN), dtype=np.uint8)
    tmpl_idx = np.asarray([0, 0, 1, 2, 2, 2, 0, 1] * 2, np.int32)
    idx = np.arange(N, dtype=np.int32) % V
    sigs = np.stack([np.frombuffer(ref.sign(
        seeds[idx[i]], templates[tmpl_idx[i]].tobytes()), np.uint8)
        for i in range(N)])
    sigs[6] = sigs[5]                       # a lane with another's sig
    sigs[10, 40] ^= 1
    want = np.asarray(jed.verify_grouped_jit(
        jnp.asarray(jtbl), jnp.asarray(jok), jnp.asarray(idx),
        jnp.asarray(pubs[idx]), jnp.asarray(templates[tmpl_idx]),
        jnp.asarray(sigs)))
    assert want.tolist() == _golden(pubs, idx, templates[tmpl_idx], sigs)
    t = torch.tensor
    got = ed.verify_grouped_templated(
        t(jtbl), t(jok), t(pubs), t(idx), t(tmpl_idx), t(templates), t(sigs),
        ed.base_table("cpu")).numpy()
    assert got.tolist() == want.tolist()
    got12 = backend.verify_grouped_templated(b"set", pubs, idx[:12],
                                             tmpl_idx[:12], templates,
                                             sigs[:12])
    assert got12.tolist() == want[:12].tolist()
    with pytest.raises(ValueError):
        backend.verify_grouped_templated(b"set", pubs, idx + 1, tmpl_idx,
                                         templates, sigs)


def test_verify_grouped_index_out_of_range(keyset):
    """A lane whose val_idx is -1 or V (or whose tmpl_idx is -1 or the
    template count) verifies False on the plain versions, and every other
    lane gives the reference's verdict: the port's one rule for indices
    out of range (the kernels' and the plain versions'), where the JAX
    package's `jnp.take` wraps and fills."""
    seeds, pubs, jtbl, jok = keyset
    idx, msgs, sigs = _lanes(seeds)
    want = np.asarray(jed.verify_grouped_jit(
        jnp.asarray(jtbl), jnp.asarray(jok), jnp.asarray(idx),
        jnp.asarray(pubs[idx]), jnp.asarray(msgs), jnp.asarray(sigs)))
    assert want[[0, 8]].all()
    t = torch.tensor
    tbl, ok, base = t(jtbl), t(jok), ed.base_table("cpu")
    bad_v = idx.copy()
    bad_v[0], bad_v[8] = -1, V                  # two valid lanes' keys
    got = ed.verify_grouped_plain(tbl, ok, t(bad_v), t(pubs[idx]), t(msgs),
                                  t(sigs), base).numpy()
    out = np.isin(np.arange(N), [0, 8])
    assert not got[out].any()
    assert got[~out].tolist() == want[~out].tolist()
    # templated: the 16 messages as templates, lanes reading them by index
    tmpl_idx = np.arange(N, dtype=np.int32)
    tmpl_idx[12], bad_v[15] = N, -1
    got = ed.verify_grouped_templated_plain(
        tbl, ok, t(pubs), t(bad_v), t(tmpl_idx), t(msgs), t(sigs),
        base).numpy()
    out = np.isin(np.arange(N), [0, 8, 12, 15])
    assert want[[12, 15]].all()
    assert not got[out].any()
    assert got[~out].tolist() == want[~out].tolist()
