"""Crash-point injection for persistence tests.

Reference: ebuchman/fail-test (`glide.yaml:5`) — `fail.Fail()` call sites
abort the process when FAIL_TEST_INDEX selects them
(`consensus/state.go:1285-1346`, `state/execution.go:218-237`;
exercised by `test/persist/test_failure_indices.sh`).

Copy of `tendermint_tpu/utils/fail.py`.  Fail points are *named* and
counted: `arm(index=i)` fires at the i-th hit counted from the arming,
`arm(name=n)` at a named site.  A point is armed by this explicit call,
never by an environment variable (`TM_FAIL_INDEX` / `TM_FAIL_POINT` are
not read); `disarm()` clears it.  A disarmed point costs one check.  A
fired point calls the `set_callback` hook (in-process crash simulation)
or ends the process with exit code 66.
"""

from __future__ import annotations

import os
import threading

_lock = threading.Lock()
_counter = 0
_callback = None
_target: tuple[int | None, str | None] | None = None


def set_callback(cb) -> None:
    """Testing hook: called instead of os._exit (in-process crash sim)."""
    global _callback
    _callback = cb


def arm(index: int | None = None, name: str | None = None) -> None:
    """Select the point to fire: the `index`-th hit from now (0-based),
    the first hit of `name`, or whichever comes first."""
    global _target, _counter
    if index is None and name is None:
        raise ValueError("arm() needs an index or a name")
    with _lock:
        _counter = 0
        _target = (index, name)


def disarm() -> None:
    global _target
    with _lock:
        _target = None


def fail_point(name: str) -> None:
    global _counter
    target = _target
    if target is None:
        return
    target_idx, target_name = target
    with _lock:
        idx = _counter
        _counter += 1
    hit = ((target_idx is not None and idx == target_idx) or
           (target_name is not None and name == target_name))
    if hit:
        if _callback is not None:
            _callback(name, idx)
            return
        import sys
        print(f"FAIL_POINT hit: {name} (index {idx})", file=sys.stderr,
              flush=True)
        os._exit(66)
