"""JSON-RPC server: HTTP POST, GET URI endpoints, and WebSocket events.

Reference: `rpc/lib/server/handlers.go` — every route is exposed both as
a JSON-RPC method on POST / and as a GET URI endpoint (`:26-70`), plus a
`/websocket` upgrade for subscriptions.  Copy of
`tendermint_tpu/rpc/server.py` without the Prometheus `/metrics`
endpoint, which waits for the port's metrics: a GET of it answers
"unknown method".
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qsl, urlparse

from tendermint_tpu_torch.rpc.routes import Routes
from tendermint_tpu_torch.rpc import websocket as ws


class RPCServer:
    def __init__(self, node, rpc_config):
        self.node = node
        self.routes = Routes(node)
        laddr = rpc_config.laddr
        if not laddr.startswith("tcp://"):
            raise ValueError(f"rpc.laddr must be tcp://: {laddr!r}")
        host, port = laddr[6:].rsplit(":", 1)
        outer = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *args):
                pass

            def _respond(self, code: int, body: dict):
                data = json.dumps(body).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                parsed = urlparse(self.path)
                method = parsed.path.strip("/")
                if method == "websocket":
                    self._upgrade_websocket()
                    return
                if method == "":
                    self._respond(200, {
                        "routes": sorted(outer.routes.table) +
                        ["websocket (ws upgrade)"]})
                    return
                params = dict(parse_qsl(parsed.query))
                self._call(method, params, rid=-1)

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                try:
                    req = json.loads(self.rfile.read(n) or b"{}")
                except json.JSONDecodeError:
                    self._respond(400, {"error": {"code": -32700,
                                                  "message": "parse error"}})
                    return
                self._call(req.get("method", ""), req.get("params") or {},
                           rid=req.get("id"))

            def _call(self, method, params, rid):
                fn = outer.routes.table.get(method)
                if fn is None:
                    self._respond(404, {
                        "jsonrpc": "2.0", "id": rid,
                        "error": {"code": -32601,
                                  "message": f"unknown method {method!r}"}})
                    return
                try:
                    result = fn(params)
                    self._respond(200, {"jsonrpc": "2.0", "id": rid,
                                        "result": result})
                except Exception as e:
                    self._respond(500, {"jsonrpc": "2.0", "id": rid,
                                        "error": {"code": -32603,
                                                  "message": str(e)}})

            def _upgrade_websocket(self):
                key = self.headers.get("Sec-WebSocket-Key")
                if not key:
                    self._respond(400, {"error": {
                        "code": -32600, "message": "not a ws handshake"}})
                    return
                self.send_response(101, "Switching Protocols")
                self.send_header("Upgrade", "websocket")
                self.send_header("Connection", "Upgrade")
                self.send_header("Sec-WebSocket-Accept", ws.accept_key(key))
                self.end_headers()
                ws.WSSession(self, outer.node, outer.routes).run()
                self.close_connection = True

        self._httpd = ThreadingHTTPServer((host, int(port)), Handler)
        self.port = self._httpd.server_address[1]
        self._thread: threading.Thread | None = None

    @property
    def addr(self) -> str:
        return f"http://{self._httpd.server_address[0]}:{self.port}"

    def start(self) -> None:
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True, name="rpc-http")
        self._thread.start()

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
