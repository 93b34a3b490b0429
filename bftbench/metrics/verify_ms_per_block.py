"""K1 dispatch, collection and tally (`CudaBackend`
`verify_grouped_templated_async`, `window_tally_check`):
`PipelineResult.busy_s["verify"]` of the honest replays of whole passes,
per block applied, in ms.  Moves `blocks_per_s`."""

from bftbench.metrics._shared import stage_ms_per_block

UNIT = "ms/block"


def read(ctx):
    return stage_ms_per_block(ctx, "verify")
