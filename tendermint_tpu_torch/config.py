"""Node configuration the port needs so far.

Copy of `tendermint_tpu/config.py`'s `P2PConfig`, `MempoolConfig` and
`ConsensusConfig` (reference `config/config.go`, P2P, Mempool and
Consensus sections) with the reference's defaults, and the consensus part
of `test_config()`; the other sections come with the slices that read
them.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field


@dataclass
class P2PConfig:
    laddr: str = "tcp://0.0.0.0:26656"
    seeds: list[str] = field(default_factory=list)
    persistent_peers: list[str] = field(default_factory=list)
    max_num_peers: int = 50
    pex: bool = True
    send_rate: int = 512_000             # B/s (reference p2p/connection.go:31)
    recv_rate: int = 512_000
    flush_throttle_ms: int = 100
    handshake_timeout_s: float = 20.0
    dial_timeout_s: float = 3.0
    # the fuzzed connection's profile (`p2p/fuzz.py`, not ported yet: the
    # port's switch refuses fuzz=True); kept so the sections round-trip
    fuzz: bool = False
    fuzz_drop_prob: float = 0.05
    fuzz_delay_prob: float = 0.1
    fuzz_max_delay: float = 0.05
    # persistent-peer reconnect: exponential backoff capped in SECONDS
    # (reference p2p/switch.go reconnectToPeer), a separate attempt cap,
    # and +-jitter_frac jitter so a healed partition does not bring every
    # dialer back at the same instant
    reconnect_max_attempts: int = 16
    reconnect_backoff_base_s: float = 1.0
    reconnect_backoff_max_s: float = 32.0
    reconnect_jitter_frac: float = 0.2
    # peer misbehavior scoring (p2p/switch.py): strikes accumulate per
    # peer id (across reconnects); at ban_score the peer is evicted and
    # refused in dial/accept for ban_window_s
    misbehavior_ban_score: float = 3.0
    misbehavior_ban_window_s: float = 30.0


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


@dataclass
class ConsensusConfig:
    wal_dir: str = ""
    wal_light: bool = False
    # reference config/config.go:364-381 (ms)
    timeout_propose: float = 3.0
    timeout_propose_delta: float = 0.5
    timeout_prevote: float = 1.0
    timeout_prevote_delta: float = 0.5
    timeout_precommit: float = 1.0
    timeout_precommit_delta: float = 0.5
    timeout_commit: float = 1.0
    skip_timeout_commit: bool = False
    # Multiplicative per-round timeout growth on top of the reference's
    # linear deltas (growth 1.0 = exact reference behaviour): a factor
    # > 1 overtakes any bounded delay in O(log(delay)) rounds.
    timeout_round_growth: float = 1.0
    timeout_max: float = 30.0            # cap for the exponential form
    max_block_size_txs: int = 10_000
    create_empty_blocks: bool = True
    create_empty_blocks_interval: float = 0.0

    def _grown(self, base: float, delta: float, round_: int) -> float:
        t = base + delta * round_
        g = self.timeout_round_growth
        if g > 1.0:
            # clamp the exponent to the first round where base*g^r alone
            # exceeds the cap (g^round overflows a float long after it);
            # base may be 0 in a test config, so guard the division
            base_ = max(base, 1e-9)
            max_r = math.ceil(math.log(max(self.timeout_max / base_, 1.0),
                                       g)) + 1
            t = min(t * g ** min(round_, max_r), self.timeout_max)
        return t

    def propose_timeout(self, round_: int) -> float:
        return self._grown(self.timeout_propose,
                           self.timeout_propose_delta, round_)

    def prevote_timeout(self, round_: int) -> float:
        return self._grown(self.timeout_prevote,
                           self.timeout_prevote_delta, round_)

    def precommit_timeout(self, round_: int) -> float:
        return self._grown(self.timeout_precommit,
                           self.timeout_precommit_delta, round_)


@dataclass
class Config:
    p2p: P2PConfig = field(default_factory=P2PConfig)
    mempool: MempoolConfig = field(default_factory=MempoolConfig)
    consensus: ConsensusConfig = field(default_factory=ConsensusConfig)


def test_config() -> Config:
    """Fast in-memory config (reference `config/config.go:384-396`):
    100 ms proposals, 20 ms votes and commit, the commit timeout skipped
    once every precommit is in, and failed rounds growing 1.5x a round up
    to 5 s."""
    c = Config()
    c.consensus.timeout_propose = 0.1
    c.consensus.timeout_propose_delta = 0.02
    c.consensus.timeout_prevote = 0.02
    c.consensus.timeout_prevote_delta = 0.01
    c.consensus.timeout_precommit = 0.02
    c.consensus.timeout_precommit_delta = 0.01
    c.consensus.timeout_commit = 0.02
    c.consensus.skip_timeout_commit = True
    c.consensus.timeout_round_growth = 1.5
    c.consensus.timeout_max = 5.0
    return c
