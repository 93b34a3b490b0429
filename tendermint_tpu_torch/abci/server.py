"""Socket ABCI server: exposes an Application to an external node process.

Reference: the abci repo's socket server (used when the app runs
out-of-process, `proxy/client.go:74-79`).  One thread per connection;
requests on a connection are served strictly in order.  The app itself is
guarded by one lock shared across connections, matching the in-proc
semantics in `tendermint_tpu_torch.proxy`.  Copy of
`tendermint_tpu/abci/server.py`.
"""

from __future__ import annotations

import socket
import threading

from tendermint_tpu_torch.abci import wire
from tendermint_tpu_torch.abci.app import Application
from tendermint_tpu_torch.types.codec import Reader, lp_bytes


class ABCIServer:
    def __init__(self, app: Application, addr: str = "tcp://127.0.0.1:26658"):
        if not addr.startswith("tcp://"):
            raise ValueError(f"ABCI server address must be tcp://: {addr!r}")
        host, port = addr[6:].rsplit(":", 1)
        self.app = app
        self.host, self.port = host, int(port)
        self._app_lock = threading.Lock()
        self._listener: socket.socket | None = None
        self._threads: list[threading.Thread] = []
        self._stopped = threading.Event()

    def start(self) -> None:
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((self.host, self.port))
        self.port = self._listener.getsockname()[1]   # resolve port 0
        self._listener.listen(8)
        t = threading.Thread(target=self._accept_loop, daemon=True,
                             name="abci-accept")
        t.start()
        self._threads.append(t)

    @property
    def addr(self) -> str:
        return f"tcp://{self.host}:{self.port}"

    def stop(self) -> None:
        self._stopped.set()
        if self._listener is not None:
            try:
                self._listener.close()
            except OSError:
                pass

    def _accept_loop(self) -> None:
        while not self._stopped.is_set():
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return
            t = threading.Thread(target=self._serve, args=(conn,),
                                 daemon=True, name="abci-conn")
            t.start()
            self._threads.append(t)

    def _serve(self, conn: socket.socket) -> None:
        try:
            while not self._stopped.is_set():
                msg_type, payload = wire.read_frame(conn)
                resp_type, resp = self._dispatch(msg_type, payload)
                wire.write_frame(conn, resp_type, resp)
        except (ConnectionError, OSError):
            pass
        finally:
            conn.close()

    def _dispatch(self, msg_type: int, payload: bytes) -> tuple[int, bytes]:
        return dispatch(self.app, self._app_lock, msg_type, payload)


def dispatch(app: Application, app_lock: threading.Lock, msg_type: int,
             payload: bytes) -> tuple[int, bytes]:
    """Decode one ABCI request, run it on the app under its lock, encode
    the response — the socket server's, and the gRPC server's once that
    transport is ported (reference apps attach over either transport,
    proxy/client.go:65-79)."""
    try:
        with app_lock:
            if msg_type == wire.MSG_ECHO:
                return msg_type, payload
            if msg_type == wire.MSG_INFO:
                return msg_type, wire.encode_response_info(app.info())
            if msg_type == wire.MSG_SET_OPTION:
                r = Reader(payload)
                out = app.set_option(r.lp_bytes().decode(),
                                     r.lp_bytes().decode())
                return msg_type, lp_bytes(out.encode())
            if msg_type == wire.MSG_INIT_CHAIN:
                vals = wire.decode_validators(Reader(payload))
                app.init_chain(vals)
                return msg_type, b""
            if msg_type == wire.MSG_QUERY:
                data, path, height, prove = wire.decode_request_query(
                    payload)
                return msg_type, wire.encode_response_query(
                    app.query(data, path, height, prove))
            if msg_type == wire.MSG_BEGIN_BLOCK:
                app.begin_block(wire.decode_request_begin_block(payload))
                return msg_type, b""
            if msg_type == wire.MSG_CHECK_TX:
                return msg_type, app.check_tx(
                    Reader(payload).lp_bytes()).encode()
            if msg_type == wire.MSG_DELIVER_TX:
                return msg_type, app.deliver_tx(
                    Reader(payload).lp_bytes()).encode()
            if msg_type == wire.MSG_END_BLOCK:
                height = Reader(payload).u64()
                return msg_type, wire.encode_response_end_block(
                    app.end_block(height))
            if msg_type == wire.MSG_COMMIT:
                return msg_type, app.commit().encode()
        return wire.MSG_EXCEPTION, lp_bytes(
            b"unknown message type %d" % msg_type)
    except Exception as e:  # app errors must not kill the server
        return wire.MSG_EXCEPTION, lp_bytes(str(e).encode())
