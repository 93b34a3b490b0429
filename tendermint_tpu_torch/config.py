"""Node configuration the port needs so far.

Copy of `tendermint_tpu/config.py`'s `MempoolConfig` (reference
`config/config.go`, Mempool section) with the reference's defaults; the
other sections come with the slices that read them.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class MempoolConfig:
    recheck: bool = True
    broadcast: bool = True
    wal_dir: str = ""
    cache_size: int = 100_000            # reference mempool/mempool.go:51
    # admission control (mempool/mempool.py): hard caps on resident txs
    # and bytes — at the cap a new tx is admitted only by evicting
    # strictly lower-priority txs (lowest-priority-oldest first), else
    # rejected with ERR_MEMPOOL_FULL; 0 disables a cap
    max_txs: int = 5_000                 # reference config.go Mempool.Size
    max_bytes: int = 1_073_741_824       # 1 GiB resident tx bytes
    # reject-before-verify backpressure: refuse enveloped txs outright
    # while the batch plane's mempool class already queues this many
    # lanes, so a signature flood sheds at the front door instead of
    # growing the verify queue under the consensus class; 0 disables
    backpressure_lanes: int = 4_096
