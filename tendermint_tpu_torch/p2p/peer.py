"""Peer: one connected remote node.

Reference: `p2p/peer.go` — wraps the (optionally fuzzed + encrypted)
conn, the MConnection, the peer's NodeInfo, and a per-peer data map that
reactors use for their own bookkeeping (e.g. consensus PeerState).
Copy of `tendermint_tpu/p2p/peer.py`.
"""

from __future__ import annotations

import threading

from tendermint_tpu_torch.p2p.connection import MConnection
from tendermint_tpu_torch.p2p.types import NodeInfo


class Peer:
    def __init__(self, node_info: NodeInfo, mconn: MConnection,
                 outbound: bool, persistent: bool = False):
        self.node_info = node_info
        self.mconn = mconn
        self.outbound = outbound
        self.persistent = persistent
        self.data: dict = {}            # reactor scratch (PeerState etc.)
        self._data_lock = threading.Lock()
        # misbehavior strikes charged against this connection's peer id;
        # the switch owns the authoritative per-id tally (it survives
        # reconnects) and mirrors it here for net_info/debugging
        self.misbehavior_score: float = 0.0

    @property
    def id(self) -> str:
        return self.node_info.id

    def get(self, key: str, default=None):
        with self._data_lock:
            return self.data.get(key, default)

    def set(self, key: str, value) -> None:
        with self._data_lock:
            self.data[key] = value

    def supports_channel(self, ch_id: int) -> bool:
        """Peers advertise channels in the handshake; sending on one the
        remote lacks would kill the connection (its recv routine treats
        unknown channels as protocol errors)."""
        chs = self.node_info.channels
        return not chs or ch_id in chs

    def send(self, ch_id: int, msg: bytes, timeout: float = 10.0) -> bool:
        if not self.supports_channel(ch_id):
            return False
        return self.mconn.send(ch_id, msg, timeout)

    def try_send(self, ch_id: int, msg: bytes) -> bool:
        if not self.supports_channel(ch_id):
            return False
        return self.mconn.try_send(ch_id, msg)

    def stop(self) -> None:
        self.mconn.stop()

    def __repr__(self):
        d = "out" if self.outbound else "in"
        return f"Peer[{self.id[:12]} {d} {self.node_info.moniker}]"


class Reactor:
    """Protocol-logic plugin interface (reference `p2p/switch.go:20-30`).

    Subclasses override the hooks; the switch calls them:
    - `get_channels()` declares channel descriptors
    - `add_peer`/`remove_peer` on peer lifecycle
    - `receive(ch_id, peer, msg_bytes)` on each inbound message
    """

    def __init__(self):
        self.switch = None

    def set_switch(self, switch) -> None:
        self.switch = switch

    def get_channels(self) -> list:
        return []

    def add_peer(self, peer: Peer) -> None:
        pass

    def remove_peer(self, peer: Peer, reason) -> None:
        pass

    def receive(self, ch_id: int, peer: Peer, msg: bytes) -> None:
        pass

    def start(self) -> None:
        pass

    def stop(self) -> None:
        pass
