"""App execution and block store (`state/execution.py`
`apply_window`, the kvstore, `blockchain/store.py`):
`PipelineResult.busy_s["apply"]` of the honest replays of whole passes,
per block applied, in ms.  Moves `blocks_per_s`."""

from bftbench.metrics._shared import stage_ms_per_block

UNIT = "ms/block"


def read(ctx):
    return stage_ms_per_block(ctx, "apply")
