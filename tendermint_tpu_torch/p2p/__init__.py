"""P2P communication backend.

Reference: `p2p/` (5,909 LoC Go) — Switch + MConnection + SecretConnection
+ Peer + PEX/AddrBook.  Copy of `tendermint_tpu/p2p/__init__.py`'s
exports without UPnP and the fuzzed connection, which are not ported
yet.  `switch.make_connected_switches` is the in-process multi-node
harness (reference `p2p/switch.go:495-543`).
"""

from tendermint_tpu_torch.p2p.addrbook import AddrBook
from tendermint_tpu_torch.p2p.connection import MConnection
from tendermint_tpu_torch.p2p.peer import Peer, Reactor
from tendermint_tpu_torch.p2p.pex import PEXReactor, PEX_CHANNEL
from tendermint_tpu_torch.p2p.secret import SecretConnection
from tendermint_tpu_torch.p2p.switch import (Switch, SwitchError,
                                             connect_switches, make_switch,
                                             make_connected_switches)
from tendermint_tpu_torch.p2p.transport import (Listener, StreamConn, dial,
                                                mem_pair)
from tendermint_tpu_torch.p2p.types import (ChannelDescriptor, NetAddress,
                                            NodeInfo)

__all__ = [
    "AddrBook", "MConnection", "Peer", "Reactor", "PEXReactor",
    "PEX_CHANNEL", "SecretConnection", "Switch",
    "SwitchError", "connect_switches", "make_switch",
    "make_connected_switches", "Listener", "StreamConn", "dial",
    "mem_pair", "ChannelDescriptor", "NetAddress", "NodeInfo",
]
