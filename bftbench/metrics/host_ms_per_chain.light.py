"""Commit lanes and batch plane (`types/validator.py`
`window_commit_lanes` and the tally, `batchplane/scheduler.py`,
`light/client.py`): each chain call's span, less the union of the
backend's spans inside it, per call, in ms.  Moves `headers_per_s`."""

from bftbench.metrics._shared import backend_s

UNIT = "ms/chain"


def read(ctx):
    if not ctx.records:
        return None
    return sum(c.t1 - c.t0 - backend_s(ctx, c)
               for c in ctx.records) / len(ctx.records) * 1e3
