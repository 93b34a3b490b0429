"""Part-set re-hash and commit lanes (`replay.prepare_window`:
`types/part_set.py` `from_data_batched`, `window_commit_lanes`):
`PipelineResult.busy_s["prepare"]` of the honest replays of whole passes,
per block applied, in ms.  Moves `blocks_per_s`."""

from bftbench.metrics._shared import stage_ms_per_block

UNIT = "ms/block"


def read(ctx):
    return stage_ms_per_block(ctx, "prepare")
