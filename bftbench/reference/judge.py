"""The reference's verdict on what a run's window produced.

Every number is a count of disagreements with what the reference works
out from the inputs the benchmark made, so each has the limit 0.  A
fast-sync run is judged on all five below; a relay run, which keeps no
state or store, on `verdicts` and `lanes`.

* `verdicts`: a pass or call whose outcome differs: a fast-sync pass
  that reached the tip must refuse each faulty peer's tip with
  `CommitSignatureError` at that tip's forged height and lane, having
  applied every honest block; a pass the window's end stopped must have
  raised nothing; a relay call must be accepted, or, for a chain with a
  forged signature, refused at its forged height and lane.
* `app_state`: a pass whose height, app hash (the kvstore's, replayed
  here) or last block ID (hash and part-set header, recomputed here from
  the wire bytes) differs from the reference's at that height.
* `tally`: a pass whose honest replay's tallied voting power is not
  every block it applied times the full set's power.
* `store`: a sampled stored height whose block meta, block bytes or
  seen-commit signatures differ from the inputs, a stored height above
  the state's, or a store whose height is not the state's.
* `lanes`: a sampled signature lane whose verdict by this reference's
  own ed25519 differs from what the inputs claim (honest lanes valid,
  the forged ones not): it checks the signatures the program's signer
  made for the inputs.
"""

from __future__ import annotations

import numpy as np

from bftbench.reference import chain as ref
from bftbench.reference import ed25519

LIMITS = {"verdicts": 0, "app_state": 0, "tally": 0, "store": 0,
          "lanes": 0}
SAMPLED_LANES = 24
STORED_PER_PASS = 3


def _lanes(rng, picks_of, forged: list, pubs_of, templates_of,
           sigs_of) -> int:
    """Reference verdicts of SAMPLED_LANES drawn honest lanes and the
    forged ones against what the inputs claim; the count that differ."""
    picks = [picks_of(rng) for _ in range(SAMPLED_LANES)] + list(forged)
    wrong = 0
    for p in picks:
        ok = ed25519.verify(pubs_of(p), templates_of(p), sigs_of(p))
        wrong += ok != (p not in forged)
    return wrong


def sync_heights(rng, height: int, heights: int) -> list:
    """Stored heights sampled for a pass at `height`: a few drawn ones,
    the state's own and the one above it."""
    out = {height + 1} if height < heights else set()
    if height:
        out |= {height} | {int(h) for h in rng.integers(
            1, height + 1, STORED_PER_PASS)}
    return sorted(out)


def judge_sync(t, outputs: list, rng) -> tuple:
    """(counts by check, passes judged, passes with a disagreement) for
    `outputs` of fast-sync passes over chain `t`."""
    n_vals = len(t.pubs)
    total = n_vals * t.power
    counts = dict.fromkeys(LIMITS, 0)
    failed = 0
    for o in outputs:
        bad = dict.fromkeys(LIMITS, 0)
        h = o["height"]
        if o["complete"]:
            want = [("CommitSignatureError",) + f for f in t.forged]
            bad["verdicts"] = (o["error"] is not None or h != t.blocks
                               or o["tip_errors"] != want)
        else:
            bad["verdicts"] = (o["error"] is not None or h > t.blocks
                               or bool(o["tip_errors"]))
        bid = (t.block_hash[h - 1],) + tuple(t.parts[h - 1]) if h else \
            (b"", 0, b"")
        bad["app_state"] = (not 0 <= h <= t.heights or
                            o["app_hash"] != t.app_hash[min(h, t.heights)]
                            or tuple(o["last_block_id"]) != bid)
        bad["tally"] = o["tallied"] != min(h, t.blocks) * total
        bad["store"] = o["store_height"] != h
        for sh, (meta, block, seen) in o["stored"].items():
            if sh > h:
                bad["store"] += meta is not None or block is not None
                continue
            want_seen = [t.sigs[sh - 1, v].tobytes() for v in range(n_vals)]
            bad["store"] += (
                meta != (t.block_hash[sh - 1],) + tuple(t.parts[sh - 1])
                or block != t.wire[sh - 1] or seen != want_seen)
        for k, v in bad.items():
            counts[k] += int(v)
        failed += any(bad.values())
    # a lane is (tip, height, validator); tip -1 the honest commits
    counts["lanes"] = _lanes(
        rng, lambda r: (-1, int(r.integers(1, t.heights + 1)),
                        int(r.integers(0, n_vals))),
        [(i, h, v) for i, (h, v) in enumerate(t.forged)],
        lambda p: t.pubs[p[2]], lambda p: _sync_template(t, p[1]),
        lambda p: (t.sigs[p[1] - 1, p[2]] if p[0] < 0 else
                   t.tip_sigs[p[0]][p[1] - 1 - t.blocks, p[2]]).tobytes())
    return counts, len(outputs), failed + (counts["lanes"] > 0)


def _sync_template(t, h: int) -> bytes:
    pt, ph = t.parts[h - 1]
    return ref.sign_bytes(
        t.chain_id, [h], np.frombuffer(t.block_hash[h - 1], np.uint8)[None],
        np.frombuffer(ph, np.uint8)[None], [pt])[0].tobytes()


def judge_relay(g, outputs: list, rng) -> tuple:
    """(counts by check, calls judged, calls with a disagreement) for
    `outputs` of relay calls over grid `g`."""
    forged = {c: ("CommitSignatureError", h, v) for c, h, v in g.forged}
    counts = dict.fromkeys(("verdicts", "lanes"), 0)
    failed = 0
    for o in outputs:
        want = forged.get(o["chain"])
        wrong = o["error"] != want
        counts["verdicts"] += wrong
        failed += wrong
    n_vals = len(g.chains[0].pubs)
    headers = len(g.chains[0].templates)
    counts["lanes"] = _lanes(
        rng, lambda r: (int(r.integers(0, len(g.chains))),
                        int(r.integers(1, headers + 1)),
                        int(r.integers(0, n_vals))),
        list(g.forged), lambda p: g.chains[p[0]].pubs[p[2]],
        lambda p: g.chains[p[0]].templates[p[1] - 1].tobytes(),
        lambda p: g.chains[p[0]].sigs[p[1] - 1, p[2]].tobytes())
    return counts, len(outputs), failed + (counts["lanes"] > 0)
