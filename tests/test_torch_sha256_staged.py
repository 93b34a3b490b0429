"""Kernel K4's schedule (`csrc/sha256_prefixed.cu`) as a numpy model, word
for word with the source, against hashlib and the plain version.

The staged route is modelled as its two warps, 32 lanes each, run as two
coroutines that meet only at the source's barriers: the schedule warp's
cp.async ring (copies applied as late as `cp.async.wait_group` allows, into
shared memory poisoned at the start), the padded slot offsets, the
`__byte_perm` word assembly with its word carried across stage boundaries,
the tail blocks, and the scheduled ring that hands W[t] + K[t] to the round
warp on named barriers.  The warps are interleaved in several orders (one
warp as far ahead as the barriers let it, then the other, and seeded random
orders); a barrier arrived at twice in one phase, a slot refilled before
it was read, a deadlock or a barrier left half met fails.  Every shared-
memory access is checked to be 16-byte aligned and conflict-free (any 8
neighbouring lanes on 8 distinct 16-byte bank groups).  The direct route
is modelled per row at each of its read widths.  The constants are read
from the source; `ops/sha256._k4_route` is held to the source's rule.
"""

import hashlib
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tendermint_tpu.ops import sha256 as jax_sha256
from tendermint_tpu_torch.ops import sha256

SRC = (Path(__file__).resolve().parents[1] / "tendermint_tpu_torch" / "csrc"
       / "sha256_prefixed.cu").read_text()


def _define(name: str) -> int:
    return int(re.search(rf"#define {name} (\d+)", SRC).group(1))


STAGE, RING, DEPTH = _define("K4_STAGE"), _define("K4_RING"), \
    _define("K4_DEPTH")
K = np.array(sha256._K, np.uint32)
H0 = np.array(sha256._H0, np.uint32)
RNG = np.random.default_rng(20261017)


def byte_perm(x, y, s: int):
    """`__byte_perm(x, y, s)`: result byte i is byte (s >> 4i) & 7 of the
    eight bytes y:x (x's bytes 0-3, y's 4-7)."""
    src = [(x >> np.uint32(8 * i)) & np.uint32(0xFF) for i in range(4)] + \
        [(y >> np.uint32(8 * i)) & np.uint32(0xFF) for i in range(4)]
    out = np.zeros_like(x)
    for i in range(4):
        out |= src[(s >> (4 * i)) & 7] << np.uint32(8 * i)
    return out


def word(prev, cur):
    """`sha256_word`: prev's byte 3, then cur's bytes 0..2, big-endian."""
    return byte_perm(prev, cur, 0x3456)


def rotr(x, n: int):
    return (x >> np.uint32(n)) | (x << np.uint32(32 - n))


def schedule_kw(w16: list) -> list:
    """`put_block`'s rolling window: W[t] + K[t] for t = 0..63."""
    w = list(w16)
    kw = []
    for t in range(64):
        if t >= 16:
            w15, w2 = w[(t - 15) & 15], w[(t - 2) & 15]
            s0 = rotr(w15, 7) ^ rotr(w15, 18) ^ (w15 >> np.uint32(3))
            s1 = rotr(w2, 17) ^ rotr(w2, 19) ^ (w2 >> np.uint32(10))
            w[t & 15] = w[t & 15] + s0 + w[(t - 7) & 15] + s1
        kw.append(w[t & 15] + K[t])
    return kw


def rounds_kw(st: list, kw: list) -> list:
    """`rounds_kw`: 64 rounds from W[t] + K[t], then the state add."""
    a, b, c, d, e, f, g, h = st
    for t in range(64):
        s1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25)
        ch = (e & f) ^ (~e & g)
        t1 = h + s1 + ch + kw[t]
        s0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22)
        maj = (a & b) ^ (a & c) ^ (b & c)
        h, g, f, e, d, c, b, a = g, f, e, d + t1, c, b, a, t1 + s0 + maj
    return [x + y for x, y in zip(st, (a, b, c, d, e, f, g, h))]


def tail_words(prev, r: int, bits: int, fetch) -> list:
    """`sha256_tail_words`: the stream's last one or two blocks."""
    blocks = 2 if r > 54 else 1
    out = []
    for t in range(blocks):
        w = []
        for i in range(16):
            cur = fetch(16 * t + i)
            w.append(word(prev, cur))
            prev = cur
        if t == blocks - 1:
            w[14] = w[14] | np.uint32(bits >> 32)
            w[15] = w[15] | np.uint32(bits & 0xFFFFFFFF)
        out.append(w)
    return out


def le_words(rows: np.ndarray, off: int, count: int) -> list:
    """Little-endian words of bytes [off, off + 4 count) of each row."""
    b = rows[:, off:off + 4 * count].astype(np.uint32)
    return [b[:, 4 * i] | b[:, 4 * i + 1] << 8 | b[:, 4 * i + 2] << 16
            | b[:, 4 * i + 3] << 24 for i in range(count)]


def word_tail(rows: np.ndarray, off: int, r: int):
    """`WordTail`: r / 4 loaded words, then 0x80, then zeros."""
    assert r % 4 == 0
    words = le_words(rows, off, r // 4)
    n = rows.shape[0]
    return lambda j: (words[j] if j < r // 4 else
                      np.full(n, 0x80 if j == r // 4 else 0, np.uint32))


def byte_tail(rows: np.ndarray, off: int, r: int):
    """`ByteTail`: byte i is the row's, 0x80 at i == r, else 0."""
    n = rows.shape[0]

    def fetch(j):
        v = np.zeros(n, np.uint32)
        for k in range(4):
            i = 4 * j + k
            b = (rows[:, off + i].astype(np.uint32) if i < r else
                 np.full(n, 0x80 if i == r else 0, np.uint32))
            v |= b << np.uint32(8 * k)
        return v
    return fetch


def digests(st: list) -> np.ndarray:
    """`sha256_store`: eight big-endian words -> uint8[n, 32]."""
    return np.stack(st, axis=-1).astype(">u4").view(np.uint8)


def direct_model(rows: np.ndarray, prefix: int, width: int) -> np.ndarray:
    """`sha256_direct_kernel<width>`, one lane per row: whole blocks from
    little-endian words, then the tail (bytes where width is 1)."""
    n, length = rows.shape
    st = [np.full(n, h, np.uint32) for h in H0]
    prev = np.full(n, prefix << 24, np.uint32)
    for b in range(length // 64):
        lw = le_words(rows, 64 * b, 16)
        w = []
        for i in range(16):
            w.append(word(prev, lw[i]))
            prev = lw[i]
        st = rounds_kw(st, schedule_kw(w))
    body, r = length & ~63, length & 63
    fetch = (byte_tail if width == 1 else word_tail)(rows, body, r)
    for w in tail_words(prev, r, 8 * (length + 1), fetch):
        st = rounds_kw(st, schedule_kw(w))
    return digests(st)


def check_lds128(addrs: np.ndarray) -> None:
    """One warp-wide 16-byte shared access: aligned, and each quarter-warp
    of 8 lanes on 8 distinct 16-byte bank groups (conflict-free)."""
    assert (addrs % 16 == 0).all()
    groups = (addrs // 16) % 8
    for q in range(0, len(addrs), 8):
        assert len(set(groups[q:q + 8].tolist())) == len(groups[q:q + 8])


class Barriers:
    """Named barriers shared by two warps: a phase completes when one warp
    arrives (bar.arrive) and the other syncs (bar.sync), or both sync."""

    def __init__(self):
        self.phase = {}                     # id -> warps arrived this phase
        self.done = {}                      # id -> completed phases

    def arrive(self, bar: int, warp: int) -> int:
        """Record `warp`'s arrival; returns the phase it arrived in."""
        arrived = self.phase.setdefault(bar, set())
        assert warp not in arrived, f"warp {warp} arrived twice at {bar}"
        arrived.add(warp)
        phase = self.done.get(bar, 0)
        if len(arrived) == 2:
            self.phase[bar] = set()
            self.done[bar] = phase + 1
        return phase

    def passed(self, bar: int, phase: int) -> bool:
        return self.done.get(bar, 0) > phase


class Smem:
    """A block's dynamic shared memory, poisoned, with per-slot state."""

    def __init__(self, stage: int, ring: int, depth: int):
        self.slot = stage + 16
        self.ring_bytes = ring * 32 * self.slot
        self.bytes = np.full(self.ring_bytes, 0xA5, np.uint8)
        self.kw = np.full((depth, 16, 32, 4), 0xA5A5A5A5, np.uint32)
        self.full = [False] * depth
        self.unread = [None] * ring          # stage a ring slot holds


def staged_block(rows: np.ndarray, n_rows: int, prefix: int, stage: int,
                 ring: int, depth: int, order) -> np.ndarray:
    """One block of the staged route over `rows` (the block's 32 rows of
    the batch, the first n_rows real): the two warps as coroutines."""
    length = rows.shape[1]
    body, r = length & ~63, length & 63
    nb = body // 64 + (2 if r > 54 else 1)
    stages = -(-body // stage)
    lanes = np.arange(32)
    sm = Smem(stage, ring, depth)
    bars = Barriers()
    empty = lambda s: 1 + s                 # noqa: E731
    full = lambda s: 1 + depth + s          # noqa: E731
    out = {}

    def put_block(g, w):
        s = g % depth
        yield ("sync", empty(s))
        assert not sm.full[s], f"scheduled slot {s} refilled before read"
        kw = schedule_kw(w)
        for q in range(16):
            addrs = sm.ring_bytes + 16 * ((s * 16 + q) * 32 + lanes)
            check_lds128(addrs)
            sm.kw[s, q] = np.stack(kw[4 * q:4 * q + 4], axis=-1)
        sm.full[s] = True
        yield ("arrive", full(s))

    def schedule_warp():
        groups, pending = [], []

        def issue(k):
            off = k * stage
            if off < body:
                s = k % ring
                assert sm.unread[s] is None, f"ring slot {s} refilled " \
                    f"before stage {sm.unread[s]} was read"
                sm.unread[s] = k
                pieces = min(stage, body - off) // 16
                for rr in range(n_rows):
                    for j0 in range(0, pieces, 32):
                        j = j0 + lanes[lanes < pieces - j0]
                        dst = (s * 32 + rr) * sm.slot + 16 * j
                        if len(j) == 32:
                            assert (np.diff(dst) == 16).all()
                        pending.extend(zip(dst, [rr] * len(j), off + 16 * j))
            groups.append(list(pending))
            pending.clear()

        def wait(allowed):
            while len(groups) > allowed:
                for dst, rr, src in groups.pop(0):
                    sm.bytes[dst:dst + 16] = rows[rr, src:src + 16]

        prev = np.full(32, prefix << 24, np.uint32)
        g = 0
        for k in range(ring - 1):
            issue(k)
        for k in range(stages):
            issue(k + ring - 1)
            wait(ring - 1)
            base = (k % ring) * 32 * sm.slot
            blocks = min(stage, body - k * stage) // 64
            for b in range(blocks):
                addr = base + lanes * sm.slot + 64 * b
                for q in range(4):
                    check_lds128(addr + 16 * q)
                data = np.stack([sm.bytes[a:a + 64] for a in addr])
                lw = le_words(data, 0, 16)
                w = []
                for i in range(16):
                    w.append(word(prev, lw[i]))
                    prev = lw[i]
                yield from put_block(g, w)
                g += 1
            sm.unread[k % ring] = None
        # lanes past the batch read row 0's tail
        tail_rows = rows[np.where(lanes < n_rows, lanes, 0)]
        for w in tail_words(prev, r, 8 * (length + 1),
                            word_tail(tail_rows, body, r)):
            yield from put_block(g, w)
            g += 1
        assert g == nb

    def round_warp():
        st = [np.full(32, h, np.uint32) for h in H0]
        for s in range(min(depth, nb)):
            yield ("arrive", empty(s))
        for g in range(nb):
            s = g % depth
            yield ("sync", full(s))
            assert sm.full[s], f"block {g} read from an unfilled slot"
            for q in range(16):
                check_lds128(sm.ring_bytes + 16 * ((s * 16 + q) * 32 + lanes))
            kw = [sm.kw[s, t // 4, :, t % 4] for t in range(64)]
            sm.full[s] = False
            st = rounds_kw(st, kw)
            if g + depth < nb:
                yield ("arrive", empty(s))
        out["digests"] = digests(st)

    warps = [schedule_warp(), round_warp()]
    waiting = [None, None]                  # (barrier, phase) a warp syncs on
    live = [True, True]
    while any(live):
        runnable = [i for i in (0, 1) if live[i] and (
            waiting[i] is None or bars.passed(*waiting[i]))]
        assert runnable, "the two warps deadlock"
        i = order(runnable)
        waiting[i] = None
        while True:
            try:
                kind, bar = next(warps[i])
            except StopIteration:
                live[i] = False
                break
            phase = bars.arrive(bar, i)
            if kind == "sync" and not bars.passed(bar, phase):
                waiting[i] = (bar, phase)
                break
    assert all(not a for a in bars.phase.values()), "a barrier left half met"
    return out["digests"][:n_rows]


ORDERS = {
    "schedule_first": lambda runnable: runnable[0],
    "rounds_first": lambda runnable: runnable[-1],
}


def random_order(seed: int):
    rng = np.random.default_rng(seed)
    return lambda runnable: runnable[int(rng.integers(len(runnable)))]


def staged_model(msgs: np.ndarray, prefix: int, stage: int = STAGE,
                 ring: int = RING, depth: int = DEPTH,
                 order=ORDERS["schedule_first"]) -> np.ndarray:
    """The staged route over every 32-row block of msgs."""
    n, length = msgs.shape
    assert length % 16 == 0 and length >= stage and stage % 128 == 0
    out = []
    for row0 in range(0, n, 32):
        rows = msgs[row0:row0 + 32]
        n_rows = rows.shape[0]
        if n_rows < 32:                     # rows past the batch: no copies
            rows = np.concatenate(
                [rows, np.zeros((32 - n_rows, length), np.uint8)])
        out.append(staged_block(rows, n_rows, prefix, stage, ring, depth,
                                order))
    return np.concatenate(out)


def _hashlib(msgs: np.ndarray, prefix: int) -> np.ndarray:
    return np.stack([np.frombuffer(hashlib.sha256(
        bytes([prefix]) + m.tobytes()).digest(), np.uint8) for m in msgs])


def _plain(msgs: np.ndarray, prefix: int) -> np.ndarray:
    return sha256.sha256_prefixed_plain(torch.as_tensor(msgs),
                                        prefix).numpy()


def _msgs(n: int, length: int) -> np.ndarray:
    return RNG.integers(0, 256, (n, length), dtype=np.uint8)


def test_constants_match_the_source():
    assert sha256.K4_STAGE == STAGE
    assert "#define K4_SLOT (K4_STAGE + 16)" in SRC
    assert STAGE % 128 == 0 and RING >= 2 and 2 * DEPTH < 16


@pytest.mark.parametrize("length", range(0, 201))
def test_direct_model_every_short_length(length):
    """Both prefixes, every read width the length allows, at 0..200."""
    m = _msgs(3, length)
    for prefix in (0x00, 0x01):
        want = _hashlib(m, prefix)
        assert (_plain(m, prefix) == want).all()
        for width in (1, 4, 16):
            if length % width == 0:
                assert (direct_model(m, prefix, width) == want).all()


@pytest.mark.parametrize("length,n", [
    (4095, 1), (4095, 33), (4097, 31), (4097, 33), (65535, 2), (65537, 2)])
def test_direct_model_long_rows(length, n):
    m = _msgs(n, length)
    assert (direct_model(m, n % 2, 1) == _hashlib(m, n % 2)).all()


@pytest.mark.parametrize("n", [1, 31, 33])
@pytest.mark.parametrize("length", [STAGE, STAGE + 16, STAGE + 48,
                                    STAGE + 64, 2 * STAGE, 4096])
def test_staged_model_at_the_kernel_stages(length, n):
    """The source's stage, ring and depth: a row of one stage, a 16- and
    48-byte tail, a one-block last stage, two stages, 4 KB; both
    prefixes; against hashlib and the plain version."""
    m = _msgs(n, length)
    prefix = length // 16 % 2
    want = _hashlib(m, prefix)
    assert (staged_model(m, prefix) == want).all()
    assert (_plain(m, prefix) == want).all()


@pytest.mark.parametrize("order", ["schedule_first", "rounds_first",
                                   "random_1", "random_2"])
@pytest.mark.parametrize("stage,ring,depth", [(128, 2, 2), (128, 3, 4),
                                              (256, 2, 7)])
def test_staged_model_small_stages_and_orders(stage, ring, depth, order):
    """Short rows through small stages, rings and scheduled depths, the
    warps interleaved in each order: lengths 128..192 and rows that end a
    stage early, at N = 1, 31 and 33, both prefixes."""
    pick = (ORDERS[order] if order in ORDERS
            else random_order(int(order.split("_")[1])))
    for length, n, prefix in ((stage, 33, 0), (stage + 16, 1, 1),
                              (stage + 64, 31, 0), (192, 33, 1),
                              (2 * stage + 48, 33, 0)):
        if length < stage:
            continue
        m = _msgs(n, length)
        assert (staged_model(m, prefix, stage, ring, depth, pick)
                == _hashlib(m, prefix)).all()


def test_staged_model_at_a_part():
    """A 64 KB part, 33 rows (a warp and one row): hashlib, and row 0
    against the plain version."""
    m = _msgs(33, 64 * 1024)
    got = staged_model(m, 0x00, order=random_order(3))
    assert (got == _hashlib(m, 0x00)).all()
    assert (got[:1] == _plain(m[:1], 0x00)).all()


def test_models_match_jax_sha256():
    """The JAX package's sha256 on prefix || msg at (4, 65), a shape its
    tests compile."""
    m = _msgs(4, 64)
    jax_got = np.asarray(jax_sha256.sha256(jnp.asarray(np.concatenate(
        [np.zeros((4, 1), np.uint8), m], axis=1))))
    for width in (1, 4, 16):
        assert (direct_model(m, 0x00, width) == jax_got).all()


@pytest.mark.parametrize("length,addr,route", [
    (STAGE, 0, ("staged", 16)),
    (STAGE - 16, 0, ("direct", 16)),
    (STAGE + 16, 0, ("staged", 16)),
    (65536, 16, ("staged", 16)),
    (65536, 8, ("direct", 4)),
    (65536, 4, ("direct", 4)),
    (65536, 3, ("direct", 1)),
    (65535, 0, ("direct", 1)),
    (STAGE + 8, 0, ("direct", 4)),
    (STAGE + 8, 2, ("direct", 1)),
    (STAGE + 2, 0, ("direct", 1)),
    (64, 0, ("direct", 16)),
    (64, 4, ("direct", 4)),
    (1000, 0, ("direct", 4)),
    (0, 0, ("direct", 16)),
])
def test_k4_route_boundaries(length, addr, route):
    assert sha256._k4_route(length, addr) == route


def test_k4_route_mirrors_the_source():
    rule = SRC[SRC.index("static int k4_route"):]
    rule = rule[:rule.index("\n}\n")]
    assert "msg_len % 16 == 0 && a % 16 == 0" in rule
    assert "msg_len >= K4_STAGE ? K4_STAGED : K4_DIRECT16" in rule
    assert "msg_len % 4 == 0 && a % 4 == 0) return K4_DIRECT4" in rule
    assert "return K4_DIRECT1" in rule
