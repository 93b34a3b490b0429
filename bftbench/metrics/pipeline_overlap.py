"""Replay pipeline (`blockchain/replay.py` `replay_pipelined`): the
stages' busy host seconds over the wall of the honest replays of whole
passes (`PipelineResult.overlap`, summed).  Moves `blocks_per_s`."""

from bftbench.metrics._shared import whole_passes

UNIT = "x"


def read(ctx):
    ps = whole_passes(ctx)
    wall = sum(p.replay.wall_s for p in ps)
    if not wall:
        return None
    return sum(sum(p.replay.busy_s.values()) for p in ps) / wall
