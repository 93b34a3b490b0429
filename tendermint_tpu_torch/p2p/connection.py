"""MConnection: one multiplexed, rate-limited connection per peer.

Reference: `p2p/connection.go:66-695` — N priority channels over one
stream; the send routine picks the channel with the least
recentlySent/priority (weighted fair scheduling, `:341-395`); messages
are chunked into fixed-size packets with an EOF flag and reassembled per
channel on the receive side (`:397-483,677-694`); ping/pong keepalive;
token-bucket throttling at the configured send/recv rates (`:18-36`).

Wire framing (all big-endian):
    packet   := type(u8) body
    type 1   := MSG  body: channel(u8) flags(u8) len(u16) payload
    type 2   := PING (empty body)
    type 3   := PONG (empty body)
flags bit0 = EOF (last packet of the message).

Copy of `tendermint_tpu/p2p/connection.py` with its message counters.
One difference: a fault of this node raised out of `on_receive` (a reactor's
`receive`), i.e. a device or batch-plane fault (`is_node_fault`), is not
the peer's doing.  The JAX connection dies of it, which drops and may
blame the peer; here the receive routine stops, keeps the error as
`fault` and hands it to `on_fault`, and the link is neither dropped nor
blamed.  Any other error out of `on_receive`, and every error in the
peer's bytes (framing, MAC, unknown channel, oversize), still kills the
connection through `on_error`, as in the JAX package.
"""

from __future__ import annotations

import struct
import threading
import time
from collections import deque

from tendermint_tpu_torch.p2p.types import ChannelDescriptor
from tendermint_tpu_torch.utils.flowrate import Meter
from tendermint_tpu_torch.utils.log import get_logger
from tendermint_tpu_torch.utils.metrics import REGISTRY

log = get_logger("p2p")

PKT_MSG, PKT_PING, PKT_PONG = 1, 2, 3
MAX_PACKET_PAYLOAD = 1024            # reference maxMsgPacketSize
FLAG_EOF = 0x01


def is_node_fault(exc: BaseException) -> bool:
    """True when `exc` is this node's own fault, not its peer's: a kernel
    that fails to build or launch, a CUDA error of torch, a stopped or
    failed batch plane (`PlaneFault`) all raise a `RuntimeError`; an
    exit of the process is no `Exception` at all."""
    return isinstance(exc, RuntimeError) or not isinstance(exc, Exception)


class _RateLimiter:
    """Token bucket: blocks the caller to keep throughput <= rate B/s."""

    def __init__(self, rate: float, burst: float | None = None):
        self.rate = float(rate)
        self.burst = burst if burst is not None else self.rate / 5
        self._tokens = self.burst
        self._last = time.monotonic()
        self._lock = threading.Lock()

    def consume(self, n: int) -> None:
        if self.rate <= 0:
            return
        with self._lock:
            now = time.monotonic()
            self._tokens = min(self.burst,
                               self._tokens + (now - self._last) * self.rate)
            self._last = now
            self._tokens -= n
            wait = -self._tokens / self.rate if self._tokens < 0 else 0.0
        if wait > 0:
            time.sleep(wait)


class _Channel:
    """Send queue + recv reassembly buffer for one channel id
    (reference `p2p/connection.go:540-675`)."""

    def __init__(self, desc: ChannelDescriptor):
        self.desc = desc
        self.send_queue: deque[bytes] = deque()
        self.sending: bytes | None = None     # message partially sent
        self.sent_pos = 0
        self.recently_sent = 0.0
        self.recving = bytearray()

    def is_send_pending(self) -> bool:
        return self.sending is not None or bool(self.send_queue)

    def next_packet(self) -> tuple[bytes, bool]:
        """Pop up to MAX_PACKET_PAYLOAD of the in-flight message."""
        if self.sending is None:
            self.sending = self.send_queue.popleft()
            self.sent_pos = 0
        chunk = self.sending[self.sent_pos:self.sent_pos + MAX_PACKET_PAYLOAD]
        self.sent_pos += len(chunk)
        eof = self.sent_pos >= len(self.sending)
        if eof:
            self.sending = None
            self.sent_pos = 0
        return chunk, eof


class MConnection:
    """Owns a StreamConn (or secret/fuzzed wrapper) and two routines.

    `on_receive(ch_id, msg_bytes)` fires on the recv thread for each
    complete message; `on_error(exc)` fires once when the connection dies;
    `on_fault(exc)` fires when `on_receive` raises a fault of this node
    (`is_node_fault`), which ends the recv routine (the error stays on
    `fault`).
    """

    def __init__(self, conn, chan_descs: list[ChannelDescriptor],
                 on_receive, on_error=None, on_fault=None,
                 send_rate: int = 512_000, recv_rate: int = 512_000,
                 ping_interval: float = 40.0,
                 flush_throttle: float = 0.1, label: str = ""):
        self.conn = conn
        self.on_receive = on_receive
        self.on_error = on_error
        self.on_fault = on_fault
        self.fault: BaseException | None = None
        self.label = label           # peer id/addr, for death reports
        self._channels = {d.id: _Channel(d) for d in chan_descs}
        self._send_limiter = _RateLimiter(send_rate)
        self._recv_limiter = _RateLimiter(recv_rate)
        self._ping_interval = ping_interval
        self._flush_throttle = flush_throttle
        self._send_cv = threading.Condition()
        self._pong_pending = 0   # PONGs owed; recv routine increments under
        #                          _send_cv, send routine drains and writes
        self._stopped = threading.Event()
        self._errored = False
        self._err_lock = threading.Lock()
        self._last_decay = time.monotonic()
        self._threads: list[threading.Thread] = []
        self.send_monitor = Meter()
        self.recv_monitor = Meter()

    # -- lifecycle ------------------------------------------------------
    def start(self) -> None:
        for target, name in ((self._send_routine, "mconn-send"),
                             (self._recv_routine, "mconn-recv")):
            t = threading.Thread(target=target, daemon=True, name=name)
            t.start()
            self._threads.append(t)

    def stop(self) -> None:
        self._stopped.set()
        with self._send_cv:
            self._send_cv.notify()
        self.conn.close()

    def _die(self, exc: Exception) -> None:
        with self._err_lock:
            if self._errored:
                return
            self._errored = True
        # stop() closes the socket, which makes the OTHER routine's
        # blocking read/write raise too — that second death is expected
        # and already deduped above.  A death after stop() was requested
        # is normal teardown (debug); anything else is a real peer error
        # and must be attributable even when no on_error is wired.
        if self._stopped.is_set():
            log.debug("connection closed", peer=self.label or "?",
                      cause=type(exc).__name__)
        else:
            log.error("connection died", peer=self.label or "?",
                      err=str(exc) or type(exc).__name__)
        self.stop()
        if self.on_error is not None:
            self.on_error(exc)

    # -- sending --------------------------------------------------------
    def send(self, ch_id: int, msg: bytes, timeout: float = 10.0) -> bool:
        """Queue a message; blocks while the channel queue is full
        (reference `sendBytes` blocking semantics)."""
        ch = self._channels.get(ch_id)
        if ch is None or self._stopped.is_set():
            return False
        deadline = time.monotonic() + timeout
        with self._send_cv:
            while len(ch.send_queue) >= ch.desc.send_queue_capacity:
                remaining = deadline - time.monotonic()
                if remaining <= 0 or self._stopped.is_set():
                    return False
                self._send_cv.wait(remaining)
            ch.send_queue.append(msg)
            self._send_cv.notify()
        return True

    def try_send(self, ch_id: int, msg: bytes) -> bool:
        """Non-blocking send (reference `trySendBytes`)."""
        ch = self._channels.get(ch_id)
        if ch is None or self._stopped.is_set():
            return False
        with self._send_cv:
            if len(ch.send_queue) >= ch.desc.send_queue_capacity:
                return False
            ch.send_queue.append(msg)
            self._send_cv.notify()
        return True

    def can_send(self, ch_id: int) -> bool:
        ch = self._channels.get(ch_id)
        if ch is None:
            return False
        return len(ch.send_queue) < ch.desc.send_queue_capacity

    def _pick_channel(self) -> _Channel | None:
        """Least recentlySent/priority among channels with pending data
        (reference `sendPacketMsg` `:341-356`)."""
        best, best_ratio = None, None
        for ch in self._channels.values():
            if not ch.is_send_pending():
                continue
            ratio = ch.recently_sent / ch.desc.priority
            if best_ratio is None or ratio < best_ratio:
                best, best_ratio = ch, ratio
        return best

    def _decay(self) -> None:
        now = time.monotonic()
        if now - self._last_decay >= 2.0:
            for ch in self._channels.values():
                ch.recently_sent *= 0.8      # reference :561-565
            self._last_decay = now

    def _send_routine(self) -> None:
        last_ping = time.monotonic()
        try:
            while not self._stopped.is_set():
                with self._send_cv:
                    ch = self._pick_channel()
                    if ch is None and not self._pong_pending:
                        self._send_cv.wait(self._flush_throttle)
                        ch = self._pick_channel()
                    pongs, self._pong_pending = self._pong_pending, 0
                    if ch is not None:
                        chunk, eof = ch.next_packet()
                        ch.recently_sent += len(chunk)
                        self._send_cv.notify()
                    else:
                        chunk = None
                # all writes happen on this thread: concurrent writes from
                # the recv routine would interleave SecretConnection frame
                # sequence numbers and fail the peer's MAC check
                for _ in range(pongs):
                    self.conn.write(struct.pack(">B", PKT_PONG))
                if chunk is not None:
                    pkt = struct.pack(
                        ">BBBH", PKT_MSG, ch.desc.id,
                        FLAG_EOF if eof else 0, len(chunk)) + chunk
                    self._send_limiter.consume(len(pkt))
                    self.conn.write(pkt)
                    self.send_monitor.update(len(pkt))
                    REGISTRY.msgs_sent.inc()
                self._decay()
                now = time.monotonic()
                if now - last_ping >= self._ping_interval:
                    self.conn.write(struct.pack(">B", PKT_PING))
                    last_ping = now
        except Exception as e:
            self._die(e)

    # -- receiving ------------------------------------------------------
    def _recv_routine(self) -> None:
        while not self._stopped.is_set():
            try:
                got = self._recv_packet()
            except Exception as e:
                self._die(e)
                return
            if got is None:
                continue
            REGISTRY.msgs_received.inc()
            try:
                self.on_receive(*got)
            except BaseException as e:
                if not is_node_fault(e):
                    # the peer's message made a reactor fail
                    self._die(e)
                    return
                # our own fault on a well-formed message: not the peer's
                self.fault = e
                log.error("receive stopped by a fault",
                          peer=self.label or "?", error=repr(e))
                if self.on_fault is not None:
                    self.on_fault(e)
                return

    def _recv_packet(self) -> tuple[int, bytes] | None:
        """Read one packet; (channel, message) when it completes one."""
        t = struct.unpack(">B", self.conn.read_exact(1))[0]
        if t == PKT_PING:
            with self._send_cv:
                self._pong_pending += 1
                self._send_cv.notify()
            return None
        if t == PKT_PONG:
            return None
        if t != PKT_MSG:
            raise ValueError(f"unknown packet type {t}")
        ch_id, flags, ln = struct.unpack(">BBH", self.conn.read_exact(4))
        payload = self.conn.read_exact(ln) if ln else b""
        self._recv_limiter.consume(5 + ln)
        self.recv_monitor.update(5 + ln)
        ch = self._channels.get(ch_id)
        if ch is None:
            raise ValueError(f"packet for unknown channel {ch_id}")
        ch.recving += payload
        if len(ch.recving) > ch.desc.recv_message_capacity:
            raise ValueError(
                f"message on channel {ch_id} exceeds "
                f"{ch.desc.recv_message_capacity} bytes")
        if not flags & FLAG_EOF:
            return None
        msg = bytes(ch.recving)
        ch.recving.clear()
        return ch_id, msg

    def status(self) -> dict:
        """Flowrate + channel-occupancy snapshot (reference
        `ConnectionStatus`, p2p/connection.go:485-515: SendMonitor /
        RecvMonitor status plus per-channel state)."""
        return {
            "send_monitor": self.send_monitor.status(),
            "recv_monitor": self.recv_monitor.status(),
            "channels": {
                ch.desc.id: {
                    "priority": ch.desc.priority,
                    "send_queue_size": len(ch.send_queue),
                    "recently_sent": round(ch.recently_sent, 1),
                } for ch in self._channels.values()
            },
        }
