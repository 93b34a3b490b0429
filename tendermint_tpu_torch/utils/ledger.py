"""Bench regression ledger: one JSONL line per bench run.

The scoreboard problem: round 4 hit 28.77x, round 5 timed out at ~12x,
and nothing in the repo recorded the trajectory in between.  The ledger
fixes that — `bench.py` appends an entry per run (per-config rates plus
the doctor's attribution partition), `cli bench-history` renders the
trajectory, and `compute_deltas` compares each config against the BEST
prior run so a slow creep over five runs is as visible as a cliff in
one.

Entries are append-only JSONL (one object per line) so concurrent
readers never see a torn file and a crashed bench leaves prior history
intact.  `load()` tolerates corrupt/partial lines: a run killed mid-
append must not brick the history command.

Copy of `tendermint_tpu/utils/ledger.py`: the same
`tpu-bft-bench-ledger/1` lines, read and written by either package.
"""

from __future__ import annotations

import json
import os

LEDGER_SCHEMA = "tpu-bft-bench-ledger/1"

DEFAULT_PATH = "BENCH_LEDGER.jsonl"

# a config "regresses" when its rate drops more than this fraction below
# the best prior run's rate for the same config
DEFAULT_REGRESSION_THRESHOLD = 0.15

# headline rate key per bench config (bench.py result dicts)
RATE_KEYS = {
    "config0": "blocks_per_sec",
    "config1": "sigs_per_sec",
    "config2": "trees_per_sec",
    "config3": "sigs_per_sec",
    "config4": "sigs_per_sec",
}


def rate_of(config_name: str, result: dict):
    """(rate, unit) for a config result, or (None, None) when the result
    has no recognizable headline rate (e.g. an errored config)."""
    key = RATE_KEYS.get(config_name)
    if key and isinstance(result.get(key), (int, float)):
        return float(result[key]), key
    # fall back to any *_per_sec field so unknown configs still track
    for k, v in sorted(result.items()):
        if k.endswith("_per_sec") and isinstance(v, (int, float)):
            return float(v), k
    return None, None


def load(path: str) -> list[dict]:
    """All parseable entries oldest-first; corrupt or truncated lines
    are skipped (a run killed mid-append must not brick history)."""
    entries: list[dict] = []
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    e = json.loads(line)
                except ValueError:
                    continue
                if isinstance(e, dict):
                    entries.append(e)
    except OSError:
        return []
    return entries


def append_entry(path: str, entry: dict) -> None:
    """Append one entry as a single JSONL line (O_APPEND + fsync: the
    line is either fully present or absent, never interleaved)."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    line = json.dumps(entry, sort_keys=True) + "\n"
    fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
    try:
        os.write(fd, line.encode())
        os.fsync(fd)
    finally:
        os.close(fd)


def best_prior(entries: list[dict]) -> dict:
    """{config_name: (best_rate, unit)} over prior entries."""
    best: dict = {}
    for e in entries:
        for cfg, res in (e.get("configs") or {}).items():
            if not isinstance(res, dict):
                continue
            rate, unit = rate_of(cfg, res)
            if rate is None:
                continue
            if cfg not in best or rate > best[cfg][0]:
                best[cfg] = (rate, unit)
    return best


def compute_deltas(prior_entries: list[dict], configs: dict,
                   threshold: float = DEFAULT_REGRESSION_THRESHOLD) -> dict:
    """Per-config comparison of `configs` (this run's results) against
    the best prior rate.  Returns {config: {rate, unit, best_prior,
    delta_frac, regression}}; configs with no prior history get
    best_prior=None and regression=False (a first run cannot regress)."""
    best = best_prior(prior_entries)
    out: dict = {}
    for cfg, res in configs.items():
        if not isinstance(res, dict):
            continue
        rate, unit = rate_of(cfg, res)
        if rate is None:
            continue
        row = {"rate": rate, "unit": unit, "best_prior": None,
               "delta_frac": None, "regression": False}
        if cfg in best and best[cfg][0] > 0:
            prior = best[cfg][0]
            row["best_prior"] = prior
            row["delta_frac"] = (rate - prior) / prior
            row["regression"] = row["delta_frac"] < -threshold
        out[cfg] = row
    return out


def render_history(entries: list[dict]) -> str:
    """Trajectory table for `cli bench-history`: one block per run with
    each config's rate and its delta vs the best of all PRIOR runs."""
    if not entries:
        return "ledger is empty (run bench.py to append an entry)"
    lines = []
    for i, e in enumerate(entries):
        when = e.get("timestamp") or e.get("git") or f"run {i + 1}"
        mode = "quick" if e.get("quick") else "full"
        lines.append(f"[{i + 1}] {when} ({mode})")
        deltas = compute_deltas(entries[:i], e.get("configs") or {})
        for cfg in sorted(deltas):
            r = deltas[cfg]
            note = ""
            if r["best_prior"] is not None:
                note = f"  ({100 * r['delta_frac']:+.1f}% vs best prior"
                note += ", REGRESSION)" if r["regression"] else ")"
            lines.append(f"    {cfg}: {r['rate']:.2f} {r['unit']}{note}")
        if not deltas:
            lines.append("    (no rates recorded)")
    return "\n".join(lines)
