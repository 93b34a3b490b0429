"""Consensus timeline plane: mesh-wide lifecycle aggregation.

The flight recorder (utils/tracing.py) and attribution partition
(utils/attribution.py) account for where a REPLAY window's wall clock
goes; this package does the same for LIVE multi-node consensus.  Every
node's ConsensusState closes a per-height lifecycle record at its
commit site (consensus/state.py `_finish_height`); the collector here
merges those records across a rig into one per-height waterfall with
clock-skew normalization, the doctor names the largest per-stage thief,
and `to_chrome_trace` renders one track per node for Perfetto.

Surfaces: `cli timeline`, the unsafe-gated `debug_timeline` RPC route,
chaos artifact bundles, and the stage-level budgets live-rounds grades.

Copy of `tendermint_tpu/telemetry/__init__.py`.  The port's
in-process rigs hand their `ConsensusState`s to `collect_mesh`.
"""

from tendermint_tpu_torch.telemetry.collector import (STAGES, TIMELINE_SCHEMA,
                                                build_timeline,
                                                collect_mesh, feed_registry,
                                                merge_dumps,
                                                normalize_record,
                                                records_from_spans,
                                                to_chrome_trace)
from tendermint_tpu_torch.telemetry.doctor import (CONSENSUS_DOCTOR_SCHEMA,
                                             consensus_doctor,
                                             render_consensus_report)

__all__ = [
    "STAGES", "TIMELINE_SCHEMA", "build_timeline", "collect_mesh",
    "feed_registry", "merge_dumps", "normalize_record",
    "records_from_spans", "to_chrome_trace",
    "CONSENSUS_DOCTOR_SCHEMA", "consensus_doctor",
    "render_consensus_report",
]
