"""The device trace's arithmetic: busy time is the union of the card's
operations, idle gaps are labelled by the innermost host span, and K1's
roofline share is its least time over its device time."""

import pytest

from bftbench import harness, trace
from bftbench.costs import k1
from bftbench.metrics import _shared

EVENTS = [("verify_grouped_kernel", 1.0, 2.0), ("Memcpy HtoD", 1.5, 2.5),
          ("verify_grouped_kernel", 4.0, 5.0), ("Memset", 9.0, 11.0)]


def test_busy_is_the_union_inside_the_window():
    assert trace.busy_intervals(EVENTS, 0.0, 10.0) == [
        [1.0, 2.5], [4.0, 5.0], [9.0, 10.0]]
    assert trace.busy_s(EVENTS, 0.0, 10.0) == pytest.approx(3.5)
    assert trace.gaps(EVENTS, 0.0, 10.0) == [(0.0, 1.0), (2.5, 4.0),
                                             (5.0, 9.0)]


def test_idle_gaps_go_to_the_innermost_host_span():
    spans = [("replay", 0.0, 10.0), ("fastsync.apply", 5.0, 8.5)]
    b = trace.breakdown(EVENTS, spans, 0.0, 10.0)
    assert b["idle_gaps"] == [["fastsync.apply", 4.0], ["replay", 2.5]]
    assert b["device_ops"][0] == ["verify_grouped_kernel", 2.0]


def context(**kw):
    cell = harness.Cell("c", {}, {"validators": 100}, {})
    return harness.Context(cell, None, [], 0.0, 10.0, **kw)


def test_idle_share_and_k1_roofline():
    # two K1 launches of 6,000 and 1,000 lanes, as their spans say
    spans = [("verify.dispatch", 0.5, 0.6, {"lanes": 6000, "bucket": 8192}),
             ("verify.dispatch", 3.5, 3.6, {"lanes": 1000, "bucket": 1024}),
             ("verify.collect", 2.0, 2.1, {"lanes": 6000})]
    ctx = context(events=EVENTS, spans=spans)
    assert _shared.idle_share(ctx) == pytest.approx(65.0)
    least = (k1.bound_s(6000, 128, 60, 100)[0]
             + k1.bound_s(1000, 128, 10, 100)[0])
    assert _shared.k1_roofline(ctx) == pytest.approx(least / 2.0 * 100)
    # a launch the trace lacks, or none at all: nothing to read
    assert _shared.k1_roofline(context(events=EVENTS,
                                       spans=spans[:1])) is None
    empty = context()
    assert _shared.idle_share(empty) is None
    assert _shared.k1_roofline(empty) is None
