"""The port's native rung (`crypto/native.py` over `native/ed25519.cpp`)
and its library (`utils/nativelib.py`, with `native/tmhash.cpp`) against
the golden `pure_ed25519`, the JAX package's OpenSSL rung and its
`nativelib`, bool for bool and byte for byte: the adversarial corpus of
`tests/test_native_backend.py` plus small-order and sign-bit encodings,
5,000 random lanes, signing, leaf hashes and Merkle roots, and the build
(concurrent builders, failures raising)."""

import hashlib
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from tendermint_tpu.crypto import native as jnative
from tendermint_tpu.types import merkle as jmerkle
from tendermint_tpu.utils import nativelib as jnativelib
from tendermint_tpu_torch.crypto import native
from tendermint_tpu_torch.crypto import pure_ed25519 as ref
from tendermint_tpu_torch.crypto.backend import PythonBackend
from tendermint_tpu_torch.types import keys, part_set
from tendermint_tpu_torch.utils import nativelib

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _torsion() -> list[bytes]:
    """The encodings of the eight points of order dividing 8: [L]P of a
    point P with a torsion component of order 8, and its multiples."""
    for y in range(2, 64):
        p = ref.pt_decode(y.to_bytes(32, "little"))
        if p is None:
            continue
        t = ref.pt_mul(ref.L, p)
        if not ref.pt_eq(ref.pt_mul(4, t), ref.IDENT):
            return sorted({ref.pt_encode(ref.pt_mul(i, t)) for i in range(8)})
    raise AssertionError("no point of order 8 found")


def _cases():
    """(pubkey, msg, sig, label): the corpus of
    `tests/test_native_backend.py:24-71`, then small-order keys and
    nonces, the sign bit on x = 0, y >= p and wrong lengths."""
    out = []
    seed = b"\x07" * 32
    pub = ref.pubkey_from_seed(seed)
    msg = b"vote sign bytes " * 8
    sig = ref.sign(seed, msg)
    out.append((pub, msg, sig, "valid"))
    out.append((pub, msg[:-1] + b"\x00", sig, "tampered msg"))
    out.append((pub, msg, sig[:32] + bytes([sig[32] ^ 1]) + sig[33:],
                "tampered s"))
    out.append((pub, msg, bytes([sig[0] ^ 1]) + sig[1:], "tampered R"))
    out.append((bytes([pub[0] ^ 1]) + pub[1:], msg, sig, "tampered pub"))
    s = int.from_bytes(sig[32:], "little")
    if s + ref.L < 2**256:
        out.append((pub, msg, sig[:32] + (s + ref.L).to_bytes(32, "little"),
                    "malleated s+L"))
    out.append((pub, msg, sig[:32] + ref.L.to_bytes(32, "little"),
                "s == L"))
    out.append((pub, msg, sig[:32] + (ref.L - 1).to_bytes(32, "little"),
                "s == L - 1"))
    out.append((pub, msg, sig[:32] + b"\xff" * 32, "s max"))
    bad_y = (ref.P + 1).to_bytes(32, "little")
    out.append((pub, msg, bad_y + sig[32:], "non-canonical R"))
    out.append((bad_y, msg, sig, "non-canonical A"))
    for k in range(19):                       # every y in [p, 2^255)
        y = (ref.P + k).to_bytes(32, "little")
        out.append((y, msg, sig, f"A y = p + {k}"))
    out.append((pub, msg, b"\x00" * 64, "zero sig"))
    out.append((b"\x00" * 32, msg, sig, "zero pub"))
    ident = (1).to_bytes(32, "little")
    out.append((ident, msg, sig, "identity pub"))
    neg_zero = (1 | 1 << 255).to_bytes(32, "little")   # x = 0, sign set
    out.append((neg_zero, msg, sig, "A x = 0 with the sign bit"))
    out.append((pub, msg, neg_zero + sig[32:], "R x = 0 with the sign bit"))
    m1 = (ref.P - 1 | 1 << 255).to_bytes(32, "little")  # (0, -1), sign set
    out.append((m1, msg, sig, "A (0, -1) with the sign bit"))
    rng = np.random.default_rng(42)
    for i in range(20):
        out.append((bytes(rng.integers(0, 256, 32, dtype=np.uint8)),
                    msg, bytes(rng.integers(0, 256, 64, dtype=np.uint8)),
                    f"random {i}"))
    for i in range(5):
        sd = bytes([i + 1]) * 32
        m = bytes([i]) * (16 + i * 37)
        out.append((ref.pubkey_from_seed(sd), m, ref.sign(sd, m),
                    f"valid {i}"))
    # small-order keys and nonces, s = 0 and 1: [s]B - [k]A == R holds
    # for some of them (cofactorless verification accepts those)
    tors = _torsion()
    for a in tors:
        for r in tors:
            out.append((a, msg, r + bytes(32), "small-order A, R, s = 0"))
        out.append((a, msg, tors[0] + (1).to_bytes(32, "little"),
                    "small-order A, s = 1"))
    out.append((pub[:31], msg, sig, "31-byte key"))
    out.append((pub + b"\x00", msg, sig, "33-byte key"))
    out.append((pub, msg, sig[:63], "63-byte signature"))
    out.append((pub, msg, sig + b"\x00", "65-byte signature"))
    return out


CASES = _cases()


def test_adversarial_corpus_matches_pure():
    """Every case gives pure_ed25519's bool, scalar and batched (the
    batch on the 32-byte keys and 64-byte signatures)."""
    want = [ref.verify(p, m, s) for p, m, s, _ in CASES]
    got = [native.verify_one(p, m, s) for p, m, s, _ in CASES]
    bad = [(c[3], w, g) for c, w, g in zip(CASES, want, got) if w != g]
    assert not bad, f"native != pure_ed25519: {bad}"
    assert any(w for (_, _, _, lab), w in zip(CASES, want)
               if lab.startswith("small-order"))
    lanes = [(i, c) for i, c in enumerate(CASES)
             if len(c[0]) == 32 and len(c[2]) == 64 and len(c[1]) == 128]
    pubs, msgs, sigs = (np.frombuffer(b"".join(c[k] for _, c in lanes),
                                      np.uint8).reshape(len(lanes), -1)
                        for k in range(3))
    for workers in (1, 4):
        out = native.NativeBackend(workers).verify_batch(pubs, msgs, sigs)
        assert list(out) == [want[i] for i, _ in lanes]


def test_small_order_corpus_has_all_eight_points():
    tors = _torsion()
    assert len(tors) == 8
    assert (1).to_bytes(32, "little") in tors          # the identity


def test_random_lanes_match_openssl():
    """5,000 lanes (valid, bit-flipped, foreign key, garbage) against the
    JAX package's OpenSSL rung, lane for lane, batched on 4 threads."""
    rng = np.random.default_rng(13)
    n = 5000
    seeds = rng.integers(0, 256, (n, 32), dtype=np.uint8)
    msgs = rng.integers(0, 256, (n, 48), dtype=np.uint8)
    pubs = np.zeros((n, 32), np.uint8)
    sigs = np.zeros((n, 64), np.uint8)
    for i in range(n):
        sd, m = seeds[i].tobytes(), msgs[i].tobytes()
        pubs[i] = np.frombuffer(native.pubkey_from_seed(sd), np.uint8)
        sigs[i] = np.frombuffer(native.sign_one(sd, m), np.uint8)
    kind = rng.integers(0, 4, n)
    flip = rng.integers(0, 64 * 8, n)
    for i in np.flatnonzero(kind == 1):                 # one bit of the sig
        sigs[i, flip[i] // 8] ^= 1 << (flip[i] % 8)
    for i in np.flatnonzero(kind == 2):                 # another lane's key
        pubs[i] = pubs[(i + 1) % n]
    for i in np.flatnonzero(kind == 3):                 # garbage
        pubs[i] = rng.integers(0, 256, 32, dtype=np.uint8)
        sigs[i] = rng.integers(0, 256, 64, dtype=np.uint8)
    got = native.NativeBackend(4).verify_batch(pubs, msgs, sigs)
    want = [jnative.verify_one(pubs[i].tobytes(), msgs[i].tobytes(),
                               sigs[i].tobytes()) for i in range(n)]
    assert list(got) == want
    assert got[kind == 0].all() and not got[kind != 0].any()
    assert [native.verify_one(pubs[i].tobytes(), msgs[i].tobytes(),
                              sigs[i].tobytes()) for i in range(200)] == \
        want[:200]


def test_sign_is_byte_identical_to_pure_and_openssl():
    for i in range(12):
        seed = hashlib.sha256(b"seed %d" % i).digest()
        msg = bytes([i]) * (i * 29)
        got = native.sign_one(seed, msg)
        assert got == ref.sign(seed, msg) == jnative.sign_one(seed, msg)
        assert native.pubkey_from_seed(seed) == ref.pubkey_from_seed(seed)
    long = bytes(range(256)) * 40                       # several blocks
    seed = b"\x42" * 32
    assert native.sign_one(seed, long) == jnative.sign_one(seed, long)


def test_keys_sign_and_verify_on_the_native_rung():
    pk = keys.PrivKey(b"\x05" * 32)
    sig = pk.sign(b"msg")
    assert sig == ref.sign(pk.seed, b"msg")
    assert pk.pub_key.verify(b"msg", sig)
    assert not pk.pub_key.verify(b"msh", sig)
    with pytest.raises(ValueError):
        native.sign_one(b"\x05" * 31, b"msg")


def test_backend_grouped_forms_match_python():
    """verify_grouped / verify_grouped_templated gather on the host, as
    the golden backend's do."""
    seeds = [bytes([i + 1]) * 32 for i in range(3)]
    vals = np.frombuffer(b"".join(ref.pubkey_from_seed(s) for s in seeds),
                         np.uint8).reshape(3, 32)
    templates = np.frombuffer(b"t" * 40 + b"u" * 40, np.uint8).reshape(2, 40)
    vi = np.array([0, 1, 2, 1], np.int32)
    ti = np.array([0, 1, 1, 0], np.int32)
    sigs = np.frombuffer(b"".join(native.sign_one(seeds[v], templates[t]
                                                  .tobytes())
                                  for v, t in zip(vi, ti)),
                         np.uint8).reshape(4, 64).copy()
    sigs[3, 5] ^= 1
    be, py = native.NativeBackend(2), PythonBackend()
    assert be.name == "native"
    args = (b"set", vals, vi, ti, templates, sigs)
    assert list(be.verify_grouped_templated(*args)) == \
        list(py.verify_grouped_templated(*args)) == [True] * 3 + [False]
    assert list(be.verify_grouped_templated_async(*args)()) == \
        [True] * 3 + [False]
    assert len(be.verify_batch(vals[:0], templates[:0], sigs[:0])) == 0


# -- tmhash ------------------------------------------------------------------

def test_leaf_hashes_match_hashlib_and_jax():
    rng = np.random.default_rng(0)
    for n, ln in ((1, 0), (100, 77), (2100, 64)):
        msgs = rng.integers(0, 256, (n, ln), dtype=np.uint8)
        got = nativelib.leaf_hashes(msgs)
        assert np.array_equal(got, jnativelib.leaf_hashes(msgs))
        for i in range(0, n, 97):
            assert got[i].tobytes() == hashlib.sha256(
                b"\x00" + msgs[i].tobytes()).digest()
    rows = rng.integers(0, 256, (9, 4096), dtype=np.uint8)
    assert np.array_equal(native.NativeBackend().leaf_hashes(rows),
                          nativelib.leaf_hashes(rows))


@pytest.mark.parametrize("n", [1, 2, 3, 7, 100])
def test_merkle_roots_match_jax(n):
    rng = np.random.default_rng(n)
    leaves = rng.integers(0, 256, (3, n, 33), dtype=np.uint8)
    got = nativelib.merkle_roots(leaves)
    assert np.array_equal(got, jnativelib.merkle_roots(leaves))
    assert got[0].tobytes() == jmerkle.root(
        [leaves[0, i].tobytes() for i in range(n)])


def test_host_part_sets_take_the_native_leaf_hashes():
    """From DEVICE_MIN_CHUNKS full parts on, a part set built with no
    backend hashes them in the library: the same header as one part at a
    time."""
    rng = np.random.default_rng(5)
    size = 256
    n = part_set.DEVICE_MIN_CHUNKS + 3
    data = rng.integers(0, 256, size * n + 17, dtype=np.uint8).tobytes()
    (ps,) = part_set.from_data_batched([data], part_size=size)
    assert ps.header.hash == jmerkle.root(
        [data[i:i + size] for i in range(0, len(data), size)])


# -- the build -----------------------------------------------------------------

_BUILDER = textwrap.dedent("""
    import sys
    from pathlib import Path
    from tendermint_tpu_torch.utils import nativelib
    nativelib.BUILD_DIR = Path(sys.argv[1])
    from tendermint_tpu_torch.crypto import native
    seed = bytes(32)
    sig = native.sign_one(seed, b"m")
    assert native.verify_one(native.pubkey_from_seed(seed), b"m", sig)
    print("loaded", nativelib.build().name)
""")


def test_two_processes_building_at_once_both_load(tmp_path):
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen([sys.executable, "-c", _BUILDER,
                               str(tmp_path)], env=env, cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    names = {o.split()[-1] for o, _ in outs}
    assert len(names) == 1
    assert sorted(os.listdir(tmp_path)) == sorted(names)   # no leftovers


def test_failed_build_raises(tmp_path, monkeypatch):
    src = tmp_path / "src"
    src.mkdir()
    for name in nativelib.SOURCES:
        (src / name).write_text("this is not C++\n")
    monkeypatch.setattr(nativelib, "SRC_DIR", src)
    monkeypatch.setattr(nativelib, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="native build failed"):
        nativelib.build()
    assert os.listdir(tmp_path / "build") == []


def test_missing_compiler_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(nativelib, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(nativelib.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        nativelib.build()
