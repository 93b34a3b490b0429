"""App connections: typed gateways from node components to one ABCI app.

Reference: `proxy/` — three narrowed connections (mempool / consensus /
query) to a single app (`proxy/app_conn.go:11-40`,
`proxy/multi_app_conn.go:12-28`) so mempool CheckTx never contends with
consensus DeliverTx, plus a ClientCreator choosing in-proc vs remote
socket apps (`proxy/client.go:65-79`).

In-proc apps are not thread-safe, so all three conns share one lock —
the same serialization the reference's local client mutex provides.
Remote socket apps (`tendermint_tpu_torch.abci.server/client`) get one
socket per conn like the reference.

Copy of `tendermint_tpu/proxy/__init__.py`.  A "grpc://host:port" spec
attaches over gRPC (`abci/grpc_app.py`); without grpcio its
`new_app_conns` raises `ImportError` naming it.
"""

from __future__ import annotations

import contextlib
import threading

from tendermint_tpu_torch.abci.app import Application, create_app


class AppConn:
    """One logical connection; serializes calls with the shared lock."""

    def __init__(self, app: Application, lock: threading.Lock):
        self._app = app
        self._lock = lock

    @contextlib.contextmanager
    def batched(self):
        """Hold the conn lock across a WINDOW of calls, yielding the raw
        app (whose methods mirror this conn's, minus the per-call lock).
        `execution.apply_window` uses this to amortize B x ~4 lock
        round-trips per fast-sync window into one acquisition; remote
        socket/grpc conns don't offer it (callers feature-detect with
        getattr and fall back to per-call locking)."""
        with self._lock:
            yield self._app

    def info(self):
        with self._lock:
            return self._app.info()

    def set_option(self, key, value):
        with self._lock:
            return self._app.set_option(key, value)

    def init_chain(self, validators):
        with self._lock:
            return self._app.init_chain(validators)

    def query(self, data, path="/", height=0, prove=False):
        with self._lock:
            return self._app.query(data, path, height, prove)

    def check_tx(self, tx):
        with self._lock:
            return self._app.check_tx(tx)

    def begin_block(self, req):
        with self._lock:
            return self._app.begin_block(req)

    def deliver_tx(self, tx):
        with self._lock:
            return self._app.deliver_tx(tx)

    def end_block(self, height):
        with self._lock:
            return self._app.end_block(height)

    def commit(self):
        with self._lock:
            return self._app.commit()


class AppConns:
    """The three typed connections (reference `proxy/multi_app_conn.go`)."""

    def __init__(self, mempool: AppConn, consensus: AppConn, query: AppConn):
        self.mempool = mempool
        self.consensus = consensus
        self.query = query


class ClientCreator:
    """Creates AppConns for an app spec (reference `proxy/client.go`).

    spec: in-proc registry name ("kvstore", "counter", ...),
    "tcp://host:port" for a remote socket app, "grpc://host:port" for an
    app served over gRPC, or an Application instance.
    """

    def __init__(self, spec):
        self.spec = spec

    def new_app_conns(self) -> AppConns:
        if isinstance(self.spec, Application):
            app = self.spec
        elif isinstance(self.spec, str) and self.spec.startswith("tcp://"):
            from tendermint_tpu_torch.abci.client import new_socket_app_conns
            return new_socket_app_conns(self.spec)
        elif isinstance(self.spec, str) and self.spec.startswith("grpc://"):
            # ABCI over gRPC (reference proxy/client.go:75-79)
            from tendermint_tpu_torch.abci.grpc_app import new_grpc_app_conns
            return new_grpc_app_conns(self.spec)
        else:
            app = create_app(self.spec)
        lock = threading.Lock()
        return AppConns(AppConn(app, lock), AppConn(app, lock),
                        AppConn(app, lock))
