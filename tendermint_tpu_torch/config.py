"""Nested configuration with defaults, fast test variants and the TOML
config file.

Reference: `config/config.go` — Config{Base, RPC, P2P, Mempool, Consensus}
(`:12-21`), defaults (`:57-132`), consensus timeouts (`:364-381`), test
variants with memdb + 10ms timeouts (`:34-42,384-396`), and
`config/toml.go` for the file.  Copy of `tendermint_tpu/config.py` with
two rules of the port: no environment variable sets a default
(`TM_CRYPTO_BACKEND` and `TM_CRYPTO_SUPERVISED` are not read), and
`crypto_backend` names one of the port's backends (`CRYPTO_BACKENDS`).
"""

from __future__ import annotations

import math
import os
import tomllib
from dataclasses import dataclass, field

# the values `BaseConfig.crypto_backend` takes (`node.node.make_backend`):
# "cuda" the kernels on the card, "cpu" their plain PyTorch versions,
# "native" the C++ host rung, "python" the golden bigint verifier
CRYPTO_BACKENDS = ("cuda", "cpu", "native", "python")


@dataclass
class BaseConfig:
    chain_id: str = ""
    home: str = "~/.tendermint_tpu_torch"
    proxy_app: str = "kvstore"           # registry name or tcp:// addr
    moniker: str = "anonymous"
    fast_sync: bool = True
    db_backend: str = "sqlite"           # sqlite | memdb
    log_level: str = "info"
    crypto_backend: str = "cuda"         # one of CRYPTO_BACKENDS

    def root(self) -> str:
        return os.path.expanduser(self.home)

    def genesis_file(self) -> str:
        return os.path.join(self.root(), "genesis.json")

    def priv_validator_file(self) -> str:
        return os.path.join(self.root(), "priv_validator.json")

    def db_dir(self) -> str:
        return os.path.join(self.root(), "data")

    def table_cache_dir(self) -> str:
        """The on-disk comb-table cache the node and `init --warm-crypto`
        share (outside `data/`, so `unsafe_reset_all` keeps it: a file is
        named by its key set's digest and cannot go stale)."""
        return os.path.join(self.root(), "comb_tables")


@dataclass
class RPCConfig:
    laddr: str = "tcp://0.0.0.0:26657"
    grpc_laddr: str = ""                 # the gRPC broadcast API (grpcio)
    unsafe: bool = False


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
    # the fuzzed connection's profile (`p2p/fuzz.py`): with fuzz=True the
    # switch wraps every link in a FuzzedConnection
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
class CryptoConfig:
    """Supervised-crypto knobs (`crypto/supervised.py`).  `supervised`
    wraps `base.crypto_backend` in the fault-tolerant ladder (cuda ->
    native -> python from "cuda"); the rest tune its breaker, timeout,
    retry and spot-check behavior.  No environment variable overrides
    them."""
    supervised: bool = False
    breaker_threshold: int = 3       # consecutive faults before trip
    breaker_cooldown_s: float = 30.0  # OPEN -> HALF-OPEN delay
    call_timeout_s: float = 60.0     # per device call; 0 disables
    retries: int = 1                 # same-rung retries before fallback
    spot_check_every: int = 0        # 0 = off; N = re-check 1 lane of
    #                                  every Nth device verify on the ref


@dataclass
class Config:
    base: BaseConfig = field(default_factory=BaseConfig)
    rpc: RPCConfig = field(default_factory=RPCConfig)
    p2p: P2PConfig = field(default_factory=P2PConfig)
    mempool: MempoolConfig = field(default_factory=MempoolConfig)
    consensus: ConsensusConfig = field(default_factory=ConsensusConfig)
    crypto: CryptoConfig = field(default_factory=CryptoConfig)


def default_config() -> Config:
    return Config()


def test_config() -> Config:
    """Fast in-memory config (reference `config/config.go:384-396`):
    memdb stores, the golden verifier, no fast-sync, 100 ms proposals,
    20 ms votes and commit, the commit timeout skipped once every
    precommit is in, and failed rounds growing 1.5x a round up to 5 s."""
    c = Config()
    c.base.db_backend = "memdb"
    c.base.crypto_backend = "python"
    c.base.fast_sync = False
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


# --- config file (TOML; reference config/toml.go + viper binding) ---------

_SECTIONS = ("base", "rpc", "p2p", "mempool", "consensus", "crypto")


def config_file(root: str) -> str:
    return os.path.join(root, "config.toml")


def save_config_file(cfg: Config, path: str) -> None:
    """Write the full config as TOML so a testnet ships one file per node
    (reference `config/toml.go` writes config.toml at init)."""
    def fmt(v) -> str:
        if isinstance(v, bool):
            return "true" if v else "false"
        if isinstance(v, (int, float)):
            return repr(v)
        if isinstance(v, list):
            return "[" + ", ".join(fmt(x) for x in v) + "]"
        return '"' + str(v).replace("\\", "\\\\").replace('"', '\\"') + '"'

    lines = ["# tendermint_tpu configuration (TOML)", ""]
    for sec in _SECTIONS:
        lines.append(f"[{sec}]")
        obj = getattr(cfg, sec)
        for k, v in vars(obj).items():
            lines.append(f"{k} = {fmt(v)}")
        lines.append("")
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write("\n".join(lines))
    os.replace(tmp, path)


def load_config_file(path: str, cfg: Config | None = None) -> Config:
    """Overlay a TOML config file onto defaults.  Unknown keys fail loudly
    (a typo silently reverting to a default is how testnets lose nights)."""
    cfg = cfg or Config()
    with open(path, "rb") as f:
        data = tomllib.load(f)
    for sec, kv in data.items():
        if sec not in _SECTIONS:
            raise ValueError(f"unknown config section [{sec}] in {path}")
        obj = getattr(cfg, sec)
        for k, v in kv.items():
            if not hasattr(obj, k):
                raise ValueError(f"unknown config key {sec}.{k} in {path}")
            cur = getattr(obj, k)
            if isinstance(cur, float) and isinstance(v, int) \
                    and not isinstance(v, bool):
                v = float(v)
            if isinstance(v, bool) and not isinstance(cur, bool):
                raise ValueError(     # bool IS an int in Python; reject
                    f"config key {sec}.{k}: expected "
                    f"{type(cur).__name__}, got bool")
            if cur is not None and not isinstance(v, type(cur)):
                raise ValueError(
                    f"config key {sec}.{k}: expected "
                    f"{type(cur).__name__}, got {type(v).__name__}")
            setattr(obj, k, v)
    return cfg
