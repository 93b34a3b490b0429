"""Backend (`crypto/backend.py`, the templated route: staging, copies,
K1's launch, the wait for its mask): the union of the recorder's
`transfer.h2d`, `verify.dispatch` and `verify.collect` spans inside each
chain call, per call, in ms.  Moves `headers_per_s`."""

from bftbench.metrics._shared import backend_s

UNIT = "ms/chain"


def read(ctx):
    if not ctx.records:
        return None
    return sum(backend_s(ctx, c) for c in ctx.records) / \
        len(ctx.records) * 1e3
