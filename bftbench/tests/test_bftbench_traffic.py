"""Each traffic generator makes the same inputs from the same seed."""

import pytest

from conftest import TINY, ref_signer
from bftbench import harness

BENCH = harness.Bench()


def make(cell, seed):
    c = BENCH.cell(cell, TINY[cell])
    return BENCH.module("traffic", c.mix["kind"]).generate(
        seed, c.mix, c.config, "cpu", ref_signer)


def flat(t):
    if hasattr(t, "wire"):
        return (t.wire, t.block_hash, t.parts, t.app_hash, t.pubs,
                t.sigs.tobytes(), [s.tobytes() for s in t.tip_sigs],
                t.forged)
    return ([(c.chain_id, c.pubs, c.hashes.tobytes(), c.templates.tobytes(),
              c.sigs.tobytes()) for c in t.chains], t.forged)


@pytest.mark.parametrize("cell", sorted(TINY))
def test_same_seed_same_inputs_and_other_seed_other_inputs(cell):
    big = 2**31 + 12345            # past 32 signed bits, as the driver's
    a, b, c = make(cell, big), make(cell, big), make(cell, big + 1)
    assert flat(a) == flat(b)
    assert flat(a) != flat(c)


def test_chain_sizes_do_not_depend_on_the_seed():
    sizes = {tuple(len(w) for w in make("fastsync.v100.load1k", s).wire)
             for s in (1, 2**33 + 1)}
    assert len(sizes) == 1


@pytest.mark.parametrize("n", [8, 1000, 1024, 6000, 62_500])
def test_forged_lanes_lie_one_in_each_half_of_a_launch(n):
    from bftbench.traffic.chain import forged_lanes
    bucket = 1 << (n - 1).bit_length()
    for lo, hi in [(0, 0), (1, 1)]:     # the ends of each draw
        first, second = forged_lanes(
            n, lambda a, b: a if lo == 0 else b - 1)
        assert 0 <= first < min(n / 2, bucket / 2)
        assert max(n / 2, bucket / 2) <= second < n


def test_forged_lanes_sit_where_the_checks_expect():
    from bftbench.reference import ed25519
    from bftbench.reference.judge import _sync_template
    t = make("fastsync.v100.load1k", 7)
    v = len(t.pubs)
    tip = t.heights - t.blocks
    assert len(t.forged) == len(t.tip_sigs) == 2
    for i, (h, lane) in enumerate(t.forged):
        assert t.blocks < h <= t.heights and 0 <= lane < v
        p = (h - t.blocks - 1) * v + lane
        assert (p < tip * v / 2) if i == 0 else (p >= tip * v / 2)
        tm = _sync_template(t, h)
        sig = t.tip_sigs[i][h - t.blocks - 1, lane].tobytes()
        assert not ed25519.verify(t.pubs[lane], tm, sig)
        assert ed25519.verify(t.pubs[lane], tm, t.sigs[h - 1, lane].tobytes())
        other = t.tip_sigs[i].copy()
        other[h - t.blocks - 1, lane] = t.sigs[h - 1, lane]
        assert (other == t.sigs[t.blocks:]).all()   # one lane forged, no more
    g = make("light.v100.c8", 7)
    assert len({c for c, _, _ in g.forged}) == len(g.forged) == 2
    for i, (fc, fh, fl) in enumerate(g.forged):
        ch = g.chains[fc]
        headers, v = len(ch.templates), len(ch.pubs)
        p = (fh - 1) * v + fl
        assert (p < headers * v / 2) if i == 0 else (p >= headers * v / 2)
        tm = ch.templates[fh - 1].tobytes()
        assert not ed25519.verify(ch.pubs[fl], tm,
                                  ch.sigs[fh - 1, fl].tobytes())
        other = (fl + 1) % v
        assert ed25519.verify(ch.pubs[other], tm,
                              ch.sigs[fh - 1, other].tobytes())
