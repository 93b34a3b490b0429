"""Minimal RFC 6455 WebSocket server glue for event subscriptions.

Reference: the rpc lib's WebSocketManager bridging the event switch to
subscribers (`rpc/lib/server/handlers.go`, `node/node.go:338-341`).
Implemented directly over the HTTP handler's socket: handshake, text and
close/ping frames — enough for subscribe/unsubscribe streams.  Copy of
`tendermint_tpu/rpc/websocket.py`: the same frames byte for byte.
"""

from __future__ import annotations

import base64
import hashlib
import json
import struct
import threading

from tendermint_tpu_torch.types.block import Block, Header

_WS_GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"


def accept_key(client_key: str) -> str:
    digest = hashlib.sha1((client_key + _WS_GUID).encode()).digest()
    return base64.b64encode(digest).decode()


def send_text(sock, payload: str) -> None:
    data = payload.encode()
    header = bytes([0x81])  # FIN + text
    n = len(data)
    if n < 126:
        header += bytes([n])
    elif n < 1 << 16:
        header += bytes([126]) + struct.pack(">H", n)
    else:
        header += bytes([127]) + struct.pack(">Q", n)
    sock.sendall(header + data)


def send_close(sock) -> None:
    try:
        sock.sendall(bytes([0x88, 0x00]))
    except OSError:
        pass


def _read_exact(rfile, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = rfile.read(n - len(buf))
        if not chunk:
            raise ConnectionError("ws closed")
        buf += chunk
    return buf


def read_frame(rfile) -> tuple[int, bytes]:
    """Returns (opcode, payload); raises ConnectionError on EOF."""
    b1, b2 = _read_exact(rfile, 2)
    opcode = b1 & 0x0F
    masked = b2 & 0x80
    n = b2 & 0x7F
    if n == 126:
        n = struct.unpack(">H", _read_exact(rfile, 2))[0]
    elif n == 127:
        n = struct.unpack(">Q", _read_exact(rfile, 8))[0]
    mask = _read_exact(rfile, 4) if masked else b"\x00" * 4
    payload = bytearray(_read_exact(rfile, n))
    if masked:
        for i in range(n):
            payload[i] ^= mask[i % 4]
    return opcode, bytes(payload)


class WSSession:
    """One websocket connection: JSON-RPC subscribe/unsubscribe requests
    in, event notifications out."""

    def __init__(self, handler, node, routes):
        self.handler = handler
        self.sock = handler.connection
        self.node = node
        self.routes = routes
        self.sub_id = f"ws-{id(self)}"
        self._send_lock = threading.Lock()
        self._subs: set[str] = set()

    def _notify(self, event: str):
        def cb(data):
            try:
                with self._send_lock:
                    send_text(self.sock, json.dumps({
                        "jsonrpc": "2.0", "method": "event",
                        "params": {"event": event,
                                   "data": _event_data_json(data)}}))
            except OSError:
                pass
        return cb

    def run(self) -> None:
        try:
            while True:
                opcode, payload = read_frame(self.handler.rfile)
                if opcode == 0x8:      # close
                    break
                if opcode == 0x9:      # ping -> pong
                    with self._send_lock:
                        self.sock.sendall(bytes([0x8A, 0x00]))
                    continue
                if opcode not in (0x1, 0x2):
                    continue
                self._handle(payload)
        except (ConnectionError, OSError):
            pass
        finally:
            for event in self._subs:
                self.node.evsw.unsubscribe(self.sub_id, event)
            send_close(self.sock)

    def _handle(self, payload: bytes) -> None:
        req = None
        try:
            req = json.loads(payload)
            method = req.get("method")
            params = req.get("params") or {}
            rid = req.get("id")
            if method == "subscribe":
                event = params["event"]
                self._subs.add(event)
                self.node.evsw.subscribe(self.sub_id, event,
                                         self._notify(event))
                result = {"subscribed": event}
            elif method == "unsubscribe":
                event = params["event"]
                self._subs.discard(event)
                self.node.evsw.unsubscribe(self.sub_id, event)
                result = {"unsubscribed": event}
            elif method in self.routes.table:
                result = self.routes.table[method](params)
            else:
                raise ValueError(f"unknown method {method!r}")
            out = {"jsonrpc": "2.0", "id": rid, "result": result}
        except Exception as e:
            out = {"jsonrpc": "2.0", "id": req.get("id") if
                   isinstance(req, dict) else None,
                   "error": {"code": -32603, "message": str(e)}}
        with self._send_lock:
            send_text(self.sock, json.dumps(out))


def _event_data_json(data):
    """Best-effort JSON projection of event payloads."""
    if isinstance(data, Block):
        return {"height": data.height, "hash": data.hash().hex(),
                "num_txs": len(data.txs)}
    if isinstance(data, Header):
        return {"height": data.height, "chain_id": data.chain_id}
    if hasattr(data, "__dict__"):
        return {k: (v.hex() if isinstance(v, bytes) else v)
                for k, v in vars(data).items()
                if isinstance(v, (int, float, str, bytes, bool))}
    return str(data)
