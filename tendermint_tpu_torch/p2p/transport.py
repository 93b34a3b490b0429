"""Byte transports: TCP listener/dialer and an in-memory pair.

Reference: `p2p/listener.go` (TCP accept loop) — UPnP port mapping is out
of scope for this framework (modern deployments pin ports).  The
in-memory transport backs `make_connected_switches`-style tests
(reference `p2p/switch.go:495-543`) with real socketpairs so the full
framing/encryption path is exercised without TCP setup.  Copy of
`tendermint_tpu/p2p/transport.py`.
"""

from __future__ import annotations

import queue
import socket
import threading

from tendermint_tpu_torch.p2p.types import NetAddress


class StreamConn:
    """Blocking duplex byte stream over a socket with exact-read semantics."""

    def __init__(self, sock: socket.socket, label: str = ""):
        self._sock = sock
        self.label = label
        self._wlock = threading.Lock()
        self._closed = threading.Event()

    def read_exact(self, n: int) -> bytes:
        buf = bytearray()
        while len(buf) < n:
            chunk = self._sock.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("connection closed")
            buf += chunk
        return bytes(buf)

    def write(self, data: bytes) -> None:
        with self._wlock:
            self._sock.sendall(data)

    def close(self) -> None:
        if not self._closed.is_set():
            self._closed.set()
            try:
                self._sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            self._sock.close()

    @property
    def closed(self) -> bool:
        return self._closed.is_set()


def dial(addr: NetAddress, timeout: float = 3.0) -> StreamConn:
    sock = socket.create_connection((addr.host, addr.port), timeout=timeout)
    sock.settimeout(None)
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    return StreamConn(sock, label=str(addr))


def mem_pair() -> tuple[StreamConn, StreamConn]:
    """Connected in-process pair exercising the real byte path."""
    a, b = socket.socketpair()
    return StreamConn(a, "mem:a"), StreamConn(b, "mem:b")


class Listener:
    """TCP accept loop feeding a queue (reference `p2p/listener.go`)."""

    def __init__(self, laddr: NetAddress, backlog: int = 16):
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        host = laddr.host or "0.0.0.0"
        self._sock.bind((host, laddr.port))
        self._sock.listen(backlog)
        port = self._sock.getsockname()[1]
        self.addr = NetAddress("tcp", host, port)
        self._conns: queue.Queue = queue.Queue()
        self._stopped = threading.Event()
        self._thread = threading.Thread(target=self._accept_loop,
                                        daemon=True, name="p2p-accept")
        self._thread.start()

    def _accept_loop(self) -> None:
        while not self._stopped.is_set():
            try:
                sock, peer = self._sock.accept()
            except OSError:
                return
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._conns.put(StreamConn(sock, label=f"{peer[0]}:{peer[1]}"))

    def accept(self, timeout: float | None = None) -> StreamConn | None:
        try:
            return self._conns.get(timeout=timeout)
        except queue.Empty:
            return None

    def close(self) -> None:
        self._stopped.set()
        try:
            self._sock.close()
        except OSError:
            pass
