"""Mempool reactor: transaction gossip.

Reference: `mempool/reactor.go` — channel 0x30 (`:19`); a per-peer
`broadcastTxRoutine` walks the pool and pushes txs the peer hasn't seen
(`:111+`); inbound txs go through CheckTx like any local submission.

Copy of `tendermint_tpu/mempool/reactor.py`.  No fallback hides the
batch plane: the JAX `receive` logs any error of `check_tx` and its
broadcast routines log and retry any error.  Here a fault of this node
out of `check_tx` (a failed K5 flush, `p2p.connection.is_node_fault`) is
raised out of `receive` (the connection keeps it as its fault, see
`p2p/connection.py`) and kept on the reactor as `fault`; any other error
of `check_tx` is logged, as in the JAX package.  An error in a broadcast
routine ends it and is kept the same way; `stop()` raises it.
"""

from __future__ import annotations

import threading

from tendermint_tpu_torch.p2p.connection import is_node_fault
from tendermint_tpu_torch.p2p.peer import Peer, Reactor
from tendermint_tpu_torch.p2p.types import ChannelDescriptor
from tendermint_tpu_torch.utils.log import get_logger

log = get_logger("mempool")

MEMPOOL_CHANNEL = 0x30
BROADCAST_SLEEP = 0.1    # idle-only safety net; gossip is event-driven


class MempoolReactor(Reactor):
    def __init__(self, mempool, broadcast: bool = True):
        super().__init__()
        self.mempool = mempool
        self.broadcast = broadcast
        self._peer_stops: dict[str, threading.Event] = {}
        self._lock = threading.Lock()
        # event-driven gossip (same shape as the consensus reactor): a
        # new local/gossiped tx bumps the sequence and wakes the
        # broadcast routines; idle routines block instead of busy-polling
        self._wake = threading.Condition()
        self._wake_seq = 0
        # the first error of check_tx or of a broadcast routine
        self.fault: BaseException | None = None
        if hasattr(mempool, "add_notify_cb"):
            mempool.add_notify_cb(self._notify_work)

    def _notify_work(self) -> None:
        with self._wake:
            self._wake_seq += 1
            self._wake.notify_all()

    def wake(self) -> None:
        """Cross-reactor nudge: the consensus reactor calls this when a
        peer's advertised height advances, so height-gated txs retry
        immediately instead of waiting out BROADCAST_SLEEP (the safety
        net would mask the coupling if the sleep were ever raised)."""
        self._notify_work()

    def _wait_work(self, seen_seq: int, timeout: float) -> None:
        with self._wake:
            if self._wake_seq == seen_seq:
                self._wake.wait(timeout)

    def get_channels(self):
        return [ChannelDescriptor(id=MEMPOOL_CHANNEL, priority=5,
                                  send_queue_capacity=100)]

    def add_peer(self, peer: Peer) -> None:
        if not self.broadcast:
            return
        stop = threading.Event()
        with self._lock:
            self._peer_stops[peer.id] = stop
        threading.Thread(target=self._broadcast_tx_routine,
                         args=(peer, stop), daemon=True,
                         name=f"mempool-gossip-{peer.id[:8]}").start()

    def remove_peer(self, peer: Peer, reason) -> None:
        with self._lock:
            stop = self._peer_stops.pop(peer.id, None)
        if stop is not None:
            stop.set()
        self._notify_work()

    def stop(self) -> None:
        """Stop the broadcast routines; raise the reactor's fault, if
        there is one."""
        with self._lock:
            for ev in self._peer_stops.values():
                ev.set()
        if hasattr(self.mempool, "remove_notify_cb"):
            self.mempool.remove_notify_cb(self._notify_work)
        self._notify_work()
        if self.fault is not None:
            raise self.fault

    def _on_fault(self, exc: BaseException) -> None:
        with self._lock:
            if self.fault is None:
                self.fault = exc

    def receive(self, ch_id: int, peer: Peer, msg: bytes) -> None:
        """A gossiped tx enters through CheckTx exactly like RPC
        submissions (reference `:105-109`); the cache dedupes loops.  A
        fault of this node out of CheckTx is kept and raised; any other
        error is logged (a rejected tx is a result, not an error)."""
        if not msg:
            return
        try:
            self.mempool.check_tx(msg)
        except BaseException as e:
            if not is_node_fault(e):
                log.exception("gossiped tx failed CheckTx", peer=peer.id[:8])
                return
            self._on_fault(e)
            raise

    def _broadcast_tx_routine(self, peer: Peer,
                              stop: threading.Event) -> None:
        try:
            self._broadcast_txs(peer, stop)
        except BaseException as e:
            log.error("tx broadcast stopped by a fault", peer=peer.id[:8],
                      error=repr(e))
            self._on_fault(e)

    def _broadcast_txs(self, peer: Peer, stop: threading.Event) -> None:
        """Push pool txs the peer hasn't been sent yet (reference's
        clist walk with NextWait becomes a sent-set sweep)."""
        sent: set[bytes] = set()
        while not stop.is_set():
            seq = self._wake_seq
            # height-gating (reference `:111+` waits on peer height,
            # PER TX against its admission height): a peer still
            # fast-syncing would only discard pushes of txs admitted
            # far ahead of it — but gating on the pool's moving
            # height would starve old txs whenever the peer's
            # advertised height lags a block, so the reference allows
            # one-behind per tx
            ps = peer.get("consensus")
            peer_h = ps.prs.height if ps is not None else None
            pairs = self.mempool.txs_with_heights()
            live = set()
            pushed = False
            for h, tx, admit_h in pairs:
                live.add(h)
                if h in sent:
                    continue
                if peer_h is not None and peer_h < admit_h - 1:
                    continue     # peer too far behind for this tx
                if peer.send(MEMPOOL_CHANNEL, tx, timeout=5.0):
                    sent.add(h)
                    pushed = True
            # prune hashes no longer in the pool (committed/evicted)
            sent &= live
            if not pushed:
                self._wait_work(seq, BROADCAST_SLEEP)
