"""RPC clients: HTTP, in-process Local, and a minimal WebSocket client.

Reference: `rpc/client/` — `Client` interface with HTTP and Local
implementations (`interface.go`, `httpclient.go`, `localclient.go`).
Copy of `tendermint_tpu/rpc/client.py`.
"""

from __future__ import annotations

import base64
import json
import os
import socket
import struct
import urllib.error
import urllib.request

from tendermint_tpu_torch.rpc import websocket as ws
from tendermint_tpu_torch.rpc.routes import Routes


class RPCError(Exception):
    pass


class HTTPClient:
    """JSON-RPC over HTTP POST (reference httpclient.go)."""

    def __init__(self, addr: str, timeout: float = 65.0):
        self.addr = addr.rstrip("/")
        self.timeout = timeout
        self._id = 0

    def call(self, method: str, **params):
        self._id += 1
        body = json.dumps({"jsonrpc": "2.0", "id": self._id,
                           "method": method, "params": params}).encode()
        req = urllib.request.Request(
            self.addr, data=body,
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                out = json.loads(resp.read())
        except urllib.error.HTTPError as e:
            out = json.loads(e.read())
        if "error" in out and out["error"]:
            raise RPCError(out["error"].get("message", str(out["error"])))
        return out["result"]

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        return lambda **params: self.call(name, **params)


class LocalClient:
    """Direct in-process dispatch (reference localclient.go)."""

    def __init__(self, node):
        self._routes = Routes(node)

    def call(self, method: str, **params):
        fn = self._routes.table.get(method)
        if fn is None:
            raise RPCError(f"unknown method {method!r}")
        return fn(params)

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        return lambda **params: self.call(name, **params)


class WSClient:
    """Minimal client for /websocket subscriptions (tests, tooling)."""

    def __init__(self, addr: str, timeout: float = 30.0):
        # addr is the http addr; connect raw TCP and upgrade
        if not addr.startswith("http://"):
            raise ValueError(f"WSClient needs an http:// address: {addr!r}")
        host, port = addr[7:].rstrip("/").rsplit(":", 1)
        self._sock = socket.create_connection((host, int(port)),
                                              timeout=timeout)
        key = base64.b64encode(os.urandom(16)).decode()
        req = (f"GET /websocket HTTP/1.1\r\nHost: {host}\r\n"
               f"Upgrade: websocket\r\nConnection: Upgrade\r\n"
               f"Sec-WebSocket-Key: {key}\r\n"
               f"Sec-WebSocket-Version: 13\r\n\r\n")
        self._sock.sendall(req.encode())
        # read the 101 response headers
        buf = b""
        while b"\r\n\r\n" not in buf:
            chunk = self._sock.recv(4096)
            if not chunk:
                raise ConnectionError("ws handshake failed")
            buf += chunk
        if b"101" not in buf.split(b"\r\n", 1)[0]:
            raise ConnectionError(f"ws handshake rejected: {buf[:200]!r}")
        self._rfile = self._sock.makefile("rb")
        self._id = 0

    def _send(self, obj: dict) -> None:
        # client frames must be masked
        data = json.dumps(obj).encode()
        mask = os.urandom(4)
        masked = bytes(b ^ mask[i % 4] for i, b in enumerate(data))
        n = len(data)
        if n < 126:
            header = bytes([0x81, 0x80 | n])
        else:
            header = bytes([0x81, 0x80 | 126]) + struct.pack(">H", n)
        self._sock.sendall(header + mask + masked)

    def subscribe(self, event: str) -> None:
        self._id += 1
        self._send({"jsonrpc": "2.0", "id": self._id, "method": "subscribe",
                    "params": {"event": event}})
        self.recv()   # ack

    def recv(self) -> dict:
        while True:
            opcode, payload = ws.read_frame(self._rfile)
            if opcode == 0x8:
                raise ConnectionError("ws closed")
            if opcode in (0x1, 0x2):
                return json.loads(payload)

    def close(self) -> None:
        try:
            ws.send_close(self._sock)
            self._sock.close()
        except OSError:
            pass
