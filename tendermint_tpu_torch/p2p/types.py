"""P2P identity and channel types.

Reference: `p2p/types.go` (NodeInfo compat record), `p2p/netaddress.go`,
and the ChannelDescriptor config from `p2p/connection.go:518-538`.  Copy of
`tendermint_tpu/p2p/types.py`; `NodeInfo.to_json` gives the same bytes.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field


@dataclass(frozen=True)
class NetAddress:
    """host:port endpoint; `tcp://` and `mem://` schemes supported."""
    scheme: str
    host: str
    port: int

    @classmethod
    def parse(cls, s: str) -> "NetAddress":
        scheme = "tcp"
        if "://" in s:
            scheme, _, s = s.partition("://")
        host, _, port = s.rpartition(":")
        if not host:
            host, port = s, "0"
        return cls(scheme, host, int(port))

    def __str__(self) -> str:
        return f"{self.scheme}://{self.host}:{self.port}"

    def dial_string(self) -> str:
        return f"{self.host}:{self.port}"


@dataclass
class ChannelDescriptor:
    """Per-channel QoS config (reference `p2p/connection.go:518-538`)."""
    id: int
    priority: int = 1
    send_queue_capacity: int = 100
    recv_message_capacity: int = 1_048_576


@dataclass
class NodeInfo:
    """Identity + compatibility record exchanged in the peer handshake
    (reference `p2p/types.go`; filled in `node/node.go:400-441`)."""
    pub_key: bytes               # 32-byte ed25519 node key
    moniker: str
    network: str                 # chain id
    version: str
    listen_addr: str             # advertised dialable address
    channels: tuple[int, ...] = ()
    other: dict = field(default_factory=dict)

    @property
    def id(self) -> str:
        """Peer ID: hex of the node pubkey (stable across addresses)."""
        return self.pub_key.hex()

    def to_json(self) -> bytes:
        return json.dumps({
            "pub_key": self.pub_key.hex(), "moniker": self.moniker,
            "network": self.network, "version": self.version,
            "listen_addr": self.listen_addr,
            "channels": list(self.channels), "other": self.other,
        }, sort_keys=True).encode()

    @classmethod
    def from_json(cls, raw: bytes) -> "NodeInfo":
        d = json.loads(raw.decode())
        pub = bytes.fromhex(d["pub_key"])
        if len(pub) != 32:
            raise ValueError("node pubkey must be 32 bytes")
        return cls(pub_key=pub, moniker=str(d["moniker"]),
                   network=str(d["network"]), version=str(d["version"]),
                   listen_addr=str(d["listen_addr"]),
                   channels=tuple(int(c) for c in d["channels"])[:64],
                   other=dict(d.get("other", {})))

    def compatible_with(self, other: "NodeInfo") -> None:
        """Raise unless networks match and at least one channel overlaps
        (reference `p2p/types.go` CompatibleWith)."""
        if self.network != other.network:
            raise ValueError(
                f"peer network {other.network!r} != ours {self.network!r}")
        if self.channels and other.channels and \
                not set(self.channels) & set(other.channels):
            raise ValueError("no common channels with peer")
