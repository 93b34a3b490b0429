"""Post-mortem invariant helpers.

Every helper raises `InvariantViolation` whose message carries the
evidence (heights, hashes, metric values) — that message is what the
engine writes into result.json, so a red scenario is triageable without
re-running it.  Scenario bodies stash the raw material (stores, metric
phase labels) in their observations dict; these helpers read it back.

Copy of `tendermint_tpu/scenarios/invariants.py`.
"""

from __future__ import annotations

from tendermint_tpu_torch.scenarios.engine import InvariantViolation


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise InvariantViolation(msg)


# -- safety -----------------------------------------------------------------

def no_conflicting_commits(stores: list, upto: int | None = None) -> None:
    """Agreement: every store that committed height h committed the SAME
    block at h.  The core BFT safety property — two nodes disagreeing on
    any height is consensus failure, whatever else still works."""
    top = min(s.height for s in stores)
    if upto is not None:
        top = min(top, upto)
    for h in range(1, top + 1):
        hashes = {s.load_block(h).hash() for s in stores}
        require(len(hashes) == 1,
                f"conflicting commits at height {h}: "
                f"{sorted(x.hex()[:16] for x in hashes)}")


def prefix_agreement(stores: list) -> None:
    """Agreement over each store's OWN committed prefix: every block a
    store committed matches the block the furthest-ahead store committed
    at that height.  Unlike `no_conflicting_commits` (which only checks
    up to the MINIMUM height), this catches a stale straggler that
    committed a divergent block before falling behind — the live-rig
    shape, where partitioned/crashed nodes legitimately trail the
    quorum but must never disagree with it."""
    ref = max(stores, key=lambda s: s.height)
    for s in stores:
        for h in range(1, s.height + 1):
            got, want = s.load_block(h).hash(), ref.load_block(h).hash()
            require(got == want,
                    f"prefix divergence at height {h}: a node committed "
                    f"{got.hex()[:16]}, the quorum committed "
                    f"{want.hex()[:16]}")


def chains_match(store, ref_store, upto: int) -> None:
    """The synced chain is byte-identical to the honest reference."""
    for h in range(1, upto + 1):
        got, want = store.load_block(h).hash(), ref_store.load_block(h).hash()
        require(got == want,
                f"synced block {h} diverges from honest chain: "
                f"{got.hex()[:16]} != {want.hex()[:16]}")


def metric_increased(ctx, name: str, since: str = "start",
                     until: str = "end") -> int:
    """The metric grew between two phase snapshots; returns the delta.
    The evidence backbone of 'the fault machinery actually fired'."""
    before, after = ctx.metrics(since), ctx.metrics(until)
    require(before is not None and after is not None,
            f"metric phases {since!r}/{until!r} were not snapshotted")
    b, a = before.get(name, 0), after.get(name, 0)
    require(a > b, f"metric {name} did not increase "
                   f"({since}={b} -> {until}={a})")
    return a - b


def no_silent_acceptance(ctx, injected_faults: bool = True) -> None:
    """No silent signature acceptance: every injected device fault was
    SEEN by the supervisor (surfaced as crypto_device_faults and served
    by a fallback rung), never absorbed into an accepted result.  Callers
    pair this with a state-correctness check (chains_match / app hash) —
    together they say 'faults happened, and none leaked into state'."""
    if injected_faults:
        metric_increased(ctx, "crypto_device_faults")
    before, after = ctx.metrics("start"), ctx.metrics("end")
    require(before is not None and after is not None,
            "metric phases start/end missing")
    mm_b = before.get("crypto_spot_check_mismatches", 0)
    mm_a = after.get("crypto_spot_check_mismatches", 0)
    faults_d = (after.get("crypto_device_faults", 0)
                - before.get("crypto_device_faults", 0))
    require(mm_a - mm_b <= faults_d,
            f"spot-check mismatches ({mm_a - mm_b}) not all accounted "
            f"as device faults ({faults_d}) — a wrong answer leaked")


# -- liveness ---------------------------------------------------------------

def height_progressed(label: str, before: int, after: int,
                      min_delta: int) -> None:
    """Height progress resumed after faults cleared: `after` must exceed
    `before` by at least `min_delta` (measured within the scenario's
    deadline — the bound is the scenario's run budget)."""
    require(after - before >= min_delta,
            f"{label}: height only moved {before} -> {after} "
            f"(needed +{min_delta}) after faults cleared")


def completed(obs: dict, key: str, what: str) -> None:
    """The scenario's terminal condition was reached inside its budget
    (obs[key] is set truthy by the body when the deadline was met)."""
    require(bool(obs.get(key)), f"{what} did not complete in budget "
                                f"(observations[{key!r}]={obs.get(key)!r})")
