"""PEX (peer exchange) reactor: address gossip + ensure-peers loop.

Reference: `p2p/pex_reactor.go:14-50` — channel 0x00; peers request/
respond with known addresses; a 30s loop dials until the outbound target
is met; per-peer message-rate cap guards against flooding.

Copy of `tendermint_tpu/p2p/pex.py`, with the port's rule for errors of
this node: an error out of the ensure-peers loop ends it and stays on
the reactor as `fault`, which `stop()` (and so `Switch.stop()`) raises;
the JAX loop logs it and carries on.  The loop's first round comes at a
random point of its first interval (the reference randomizes when the
routine starts, `p2p/pex_reactor.go` ensurePeersRoutine): the JAX loop
starts every node's rounds one interval after its start, so nodes started
together dial each other at the same instant, the switch refuses both
crossing connections as duplicates, and the same happens every interval.
The phase and the peer the loop asks for more addresses are drawn from
the book's random generator.
"""

from __future__ import annotations

import json
import logging
import threading
import time

from tendermint_tpu_torch.p2p.addrbook import AddrBook
from tendermint_tpu_torch.p2p.peer import Peer, Reactor
from tendermint_tpu_torch.p2p.types import ChannelDescriptor, NetAddress

log = logging.getLogger(__name__)

PEX_CHANNEL = 0x00
TARGET_OUTBOUND = 10
ENSURE_PEERS_INTERVAL = 30.0
MAX_MSGS_PER_SEC = 2.0       # abuse cap (reference maxMsgCountByPeer)


class PEXReactor(Reactor):
    def __init__(self, book: AddrBook,
                 ensure_interval: float = ENSURE_PEERS_INTERVAL):
        super().__init__()
        self.book = book
        self.ensure_interval = ensure_interval
        self._stopped = threading.Event()
        self._msg_counts: dict[str, list] = {}   # peer -> [window_start, n]
        self._thread: threading.Thread | None = None
        # the error that ended the ensure-peers loop (`stop` raises it)
        self.fault: BaseException | None = None

    def get_channels(self):
        return [ChannelDescriptor(id=PEX_CHANNEL, priority=1,
                                  send_queue_capacity=10)]

    def start(self) -> None:
        self._thread = threading.Thread(target=self._ensure_peers_routine,
                                        daemon=True, name="pex-ensure")
        self._thread.start()

    def stop(self) -> None:
        """Stop the ensure-peers loop; raise the fault that ended it, if
        one did."""
        self._stopped.set()
        if self.fault is not None:
            raise self.fault

    # -- gossip ---------------------------------------------------------
    def add_peer(self, peer: Peer) -> None:
        if peer.node_info.listen_addr:
            try:
                self.book.add_address(
                    NetAddress.parse(peer.node_info.listen_addr), peer.id)
            except ValueError:
                pass
        if peer.outbound:
            # inbound peers get asked for addresses; outbound were dialed
            # from the book so it already knows them
            return
        self._request_addrs(peer)

    def remove_peer(self, peer: Peer, reason) -> None:
        self._msg_counts.pop(peer.id, None)

    def _request_addrs(self, peer: Peer) -> None:
        peer.try_send(PEX_CHANNEL,
                      json.dumps({"type": "request"}).encode())

    def receive(self, ch_id: int, peer: Peer, msg: bytes) -> None:
        if self._flooding(peer):
            self.switch.stop_peer_for_error(peer, "pex flood")
            return
        try:
            d = json.loads(msg.decode())
            t = d.get("type")
        except (ValueError, UnicodeDecodeError):
            self.switch.stop_peer_for_error(peer, "bad pex message")
            return
        if t == "request":
            addrs = [str(a) for a in self.book.sample(10)]
            peer.try_send(PEX_CHANNEL, json.dumps(
                {"type": "addrs", "addrs": addrs}).encode())
        elif t == "addrs":
            for s in d.get("addrs", [])[:50]:
                try:
                    self.book.add_address(NetAddress.parse(str(s)), peer.id)
                except (ValueError, TypeError):
                    pass
        else:
            self.switch.stop_peer_for_error(peer, f"unknown pex type {t!r}")

    def _flooding(self, peer: Peer) -> bool:
        now = time.time()
        window = self._msg_counts.setdefault(peer.id, [now, 0])
        if now - window[0] > 1.0:
            window[0], window[1] = now, 0
        window[1] += 1
        return window[1] > MAX_MSGS_PER_SEC * 10  # generous burst

    # -- ensure peers ---------------------------------------------------
    def _ensure_peers_routine(self) -> None:
        try:
            wait = self.book.rng.uniform(0.0, self.ensure_interval)
            while not self._stopped.wait(wait):
                self._ensure_peers()
                wait = self.ensure_interval
        except BaseException as e:
            log.error("ensure-peers stopped by a fault: %r", e)
            self.fault = e

    def _ensure_peers(self) -> None:
        if self.switch is None:
            return
        out = sum(1 for p in self.switch.peers() if p.outbound)
        need = TARGET_OUTBOUND - out
        connected = {p.node_info.listen_addr for p in self.switch.peers()}
        for _ in range(need):
            addr = self.book.pick_address()
            if addr is None:
                break
            if str(addr) in connected:
                continue
            self.book.mark_attempt(addr)
            self.switch.dial_peer_async(addr)
        if need > 0 and self.book.size() < TARGET_OUTBOUND:
            # ask a random peer for more addresses
            peers = self.switch.peers()
            if peers:
                self._request_addrs(self.book.rng.choice(peers))
