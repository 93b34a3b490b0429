"""BlockPool: concurrent block download scheduling for fast-sync.

Reference: `blockchain/pool.go` — up to 300 heights in flight, 75 per
peer (`:14-19`), per-peer height tracking from status messages, slow/
unresponsive peers evicted (`removeTimedoutPeers` `:100-118`),
`PeekTwoBlocks`/`PopRequest`/`RedoRequest` feeding the sync loop
(`:154-201`).  The reference runs one goroutine per height
(`bpRequester`); here a single scheduler assigns request slots and the
reactor's pool routine drives (`schedule()` returns what to request),
which batches naturally with the device-verify window.  Copy of
`tendermint_tpu/blockchain/pool.py` (its `pool.evict` / `pool.redo`
instants kept), its lock the lock witness's "blockpool.lock" role, and
with two differences: when
a request is redone, and how a young peer's rate is read.

The JAX pool redoes a request REQUEST_TIMEOUT after it was sent, and
evicts a peer after MAX_PEER_TIMEOUTS redos in a row.  A peer serves its
requests in order, behind its link's rate limit: 75 pending blocks of
~31 KB at the default 512,000 B/s take ~4.6 s, so an honest peer working
through its queue is redone and evicted over and over (100 validators,
config 3's blocks).  The reference's pool instead drops a peer that sends
nothing for a while or too slowly (`blockchain/pool.go`, peerTimeout and
minRecvRate).  Here a request times out REQUEST_TIMEOUT after the later
of its sending and its peer's last delivery, as long as that peer has
answered no request sent after it; once it has, the request was skipped
or lost and times out as in the JAX pool.  A silent peer is redone and
evicted as before, a slow one by the rate rule.

The rate rule reads a peer's meter through `Meter.unbiased_rate`.  The
meter's moving average starts at zero, so the JAX pool reads a peer that
delivered one ~31 KB block and then nothing for half a second (its host
busy elsewhere) as under MIN_RECV_RATE, and evicts a source streaming at
hundreds of KB/s a second after it joined.  Without the bias it reads the
mean of what the peer delivered; a peer that drips is evicted as before.
"""

from __future__ import annotations

import threading
import time

from tendermint_tpu_torch.utils import lockwitness, tracing
from tendermint_tpu_torch.utils.flowrate import Meter
from tendermint_tpu_torch.utils.log import get_logger

log = get_logger("blockpool")

MAX_PENDING = 300                # reference maxPendingRequests
MAX_PENDING_PER_PEER = 75        # reference maxPendingRequestsPerPeer
REQUEST_TIMEOUT = 3.0            # redo a request after this long
MAX_PEER_TIMEOUTS = 4            # evict after this many consecutive redos
MIN_RECV_RATE = 10_240           # reference minRecvRate (10 KB/s),
                                 # blockchain/pool.go:14-19
STARVE_AGE = 1.0                 # a request outstanding this long marks
                                 # the peer as starving the sync window


class _Slot:
    __slots__ = ("height", "peer_id", "sent_at", "block")

    def __init__(self, height: int, peer_id: str):
        self.height = height
        self.peer_id = peer_id
        self.sent_at = time.monotonic()
        self.block = None


class BlockPool:
    def __init__(self, start_height: int,
                 min_recv_rate: int = MIN_RECV_RATE):
        self.next_height = start_height       # first height not yet popped
        self.min_recv_rate = min_recv_rate
        self._slots: dict[int, _Slot] = {}
        self._peers: dict[str, int] = {}      # peer_id -> reported height
        self._peer_pending: dict[str, int] = {}
        self._peer_timeouts: dict[str, int] = {}
        self._peer_meters: dict[str, object] = {}   # peer_id -> Meter
        # peer_id -> (monotonic time of its last delivery, the sending
        # time of the request that delivery answered)
        self._peer_last: dict[str, tuple[float, float]] = {}
        self._lock = lockwitness.new_lock("blockpool.lock",
                                          reentrant=False)
        self.on_evict = None                  # cb(peer_id, reason)

    # -- peers ----------------------------------------------------------
    def set_peer_height(self, peer_id: str, height: int) -> None:
        with self._lock:
            self._peers[peer_id] = height
            self._peer_pending.setdefault(peer_id, 0)
            self._peer_timeouts.setdefault(peer_id, 0)
            self._peer_meters.setdefault(peer_id, Meter())

    def record_bytes(self, peer_id: str, nbytes: int) -> None:
        """Feed the peer's receive meter (called per delivered block)."""
        with self._lock:
            m = self._peer_meters.get(peer_id)
        if m is not None:
            m.update(nbytes)

    def remove_peer(self, peer_id: str) -> None:
        with self._lock:
            self._peers.pop(peer_id, None)
            self._peer_pending.pop(peer_id, None)
            self._peer_timeouts.pop(peer_id, None)
            self._peer_meters.pop(peer_id, None)
            self._peer_last.pop(peer_id, None)
            for slot in list(self._slots.values()):
                if slot.peer_id == peer_id and slot.block is None:
                    del self._slots[slot.height]

    def max_peer_height(self) -> int:
        with self._lock:
            return max(self._peers.values(), default=0)

    def num_peers(self) -> int:
        with self._lock:
            return len(self._peers)

    # -- scheduling -----------------------------------------------------
    def schedule(self) -> list[tuple[int, str]]:
        """(height, peer_id) pairs the reactor should request now: new
        heights up to the in-flight cap, plus timed-out redos reassigned
        to other peers."""
        out = []
        now = time.monotonic()
        evictions: set[str] = set()
        with self._lock:
            # rate-based eviction (reference removeTimedoutPeers,
            # blockchain/pool.go:100-118): a peer that keeps a request
            # outstanding past STARVE_AGE while its delivery rate is
            # under min_recv_rate throttles the whole window — evict it
            # even though it answers just inside the redo timeout (the
            # slow-drip case the redo counter never catches)
            starving: set[str] = set()
            for slot in self._slots.values():
                if slot.block is None and now - slot.sent_at >= STARVE_AGE:
                    starving.add(slot.peer_id)
            for pid in starving:
                m = self._peer_meters.get(pid)
                # total > 0: never judge a peer that has not delivered
                # its FIRST block yet (the reference's curRate == 0
                # exclusion — "curRate can be 0 on start"); the redo
                # timeout handles truly dead peers
                if m is not None and m.total > 0 and \
                        m.age(now) >= STARVE_AGE and \
                        m.unbiased_rate(now) < self.min_recv_rate:
                    evictions.add(pid)
            # redo timed-out requests on a different peer
            for slot in self._slots.values():
                if slot.block is not None or \
                        now - self._since(slot) < REQUEST_TIMEOUT:
                    continue
                old = slot.peer_id
                self._peer_pending[old] = \
                    max(0, self._peer_pending.get(old, 1) - 1)
                t = self._peer_timeouts.get(old, 0) + 1
                self._peer_timeouts[old] = t
                if t >= MAX_PEER_TIMEOUTS:
                    evictions.add(old)
                peer = self._pick_peer(slot.height, exclude=old)
                if peer is None:
                    peer = self._pick_peer(slot.height)
                if peer is None:
                    # nobody to reassign to; don't re-count this slot
                    # against `old` on every pass
                    slot.sent_at = now
                    continue
                slot.peer_id = peer
                slot.sent_at = now
                self._peer_pending[peer] = \
                    self._peer_pending.get(peer, 0) + 1
                out.append((slot.height, peer))
            # new requests
            h = self.next_height
            while len(self._slots) < MAX_PENDING:
                while h in self._slots:
                    h += 1
                if h > self.max_peer_height_locked():
                    break
                peer = self._pick_peer(h)
                if peer is None:
                    break
                slot = _Slot(h, peer)
                self._slots[h] = slot
                self._peer_pending[peer] = \
                    self._peer_pending.get(peer, 0) + 1
                out.append((h, peer))
        for pid in evictions:
            self._evict(pid, "request timeouts")
        return out

    def _since(self, slot: _Slot) -> float:
        """When `slot`'s request timeout starts: its sending, or its
        peer's last delivery if that answered no later request."""
        last = self._peer_last.get(slot.peer_id)
        if last is None or last[1] > slot.sent_at:
            return slot.sent_at
        return max(slot.sent_at, last[0])

    def max_peer_height_locked(self) -> int:
        return max(self._peers.values(), default=0)

    def _pick_peer(self, height: int, exclude: str | None = None):
        cands = [p for p, ph in self._peers.items()
                 if ph >= height and p != exclude and
                 self._peer_pending.get(p, 0) < MAX_PENDING_PER_PEER]
        if not cands:
            return None
        # least-loaded peer spreads the window
        return min(cands, key=lambda p: self._peer_pending.get(p, 0))

    def _evict(self, peer_id: str, reason: str) -> None:
        with self._lock:
            if peer_id not in self._peers:
                return
        log.info("evicting slow peer", peer=peer_id[:12], reason=reason)
        tracing.instant("pool.evict", peer=peer_id[:12], reason=reason)
        self.remove_peer(peer_id)
        if self.on_evict is not None:
            self.on_evict(peer_id, reason)

    # -- delivery -------------------------------------------------------
    def add_block(self, peer_id: str, block) -> bool:
        """Accept a block if it matches an outstanding request from that
        peer (reference `AddBlock` pool.go:203+)."""
        with self._lock:
            slot = self._slots.get(block.height)
            if slot is None or slot.peer_id != peer_id or \
                    slot.block is not None:
                return False
            slot.block = block
            self._peer_last[peer_id] = (time.monotonic(), slot.sent_at)
            self._peer_pending[peer_id] = \
                max(0, self._peer_pending.get(peer_id, 1) - 1)
            self._peer_timeouts[peer_id] = 0
            return True

    def peek_contiguous(self, max_n: int) -> list:
        """Blocks [next_height, ...] with no gaps, up to max_n — the
        batched generalization of the reference's PeekTwoBlocks."""
        out = []
        with self._lock:
            h = self.next_height
            while len(out) < max_n:
                slot = self._slots.get(h)
                if slot is None or slot.block is None:
                    break
                out.append(slot.block)
                h += 1
        return out

    def pop(self, n: int) -> None:
        """Advance past n processed blocks (reference `PopRequest`)."""
        with self._lock:
            for _ in range(n):
                self._slots.pop(self.next_height, None)
                self.next_height += 1

    def redo(self, height: int) -> None:
        """Re-request a height whose block failed verification; the peer
        that sent it lied — evict it (reference `RedoRequest`)."""
        with self._lock:
            slot = self._slots.pop(height, None)
        if slot is not None:
            tracing.instant("pool.redo", height=height,
                            peer=slot.peer_id[:12])
            self._evict(slot.peer_id, f"bad block at height {height}")
            # drop any later blocks that peer delivered: they're suspect
            with self._lock:
                for h in list(self._slots):
                    s = self._slots[h]
                    if s.peer_id == slot.peer_id:
                        del self._slots[h]

    def is_caught_up(self) -> bool:
        """Reference `IsCaughtUp` pool.go:128 — synced to within one block
        of the best peer (peers lag by one while committing)."""
        with self._lock:
            if not self._peers:
                return False
            return self.next_height >= self.max_peer_height_locked()

    def status(self) -> dict:
        with self._lock:
            ready = sum(1 for s in self._slots.values()
                        if s.block is not None)
            return {"next_height": self.next_height,
                    "in_flight": len(self._slots) - ready,
                    "ready": ready, "peers": len(self._peers),
                    "max_peer_height": self.max_peer_height_locked(),
                    "peer_rates": {p[:12]: round(m.rate(), 1)
                                   for p, m in self._peer_meters.items()}}
