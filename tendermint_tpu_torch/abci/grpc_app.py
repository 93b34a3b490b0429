"""ABCI over gRPC: the reference's second out-of-process app transport.

Reference: `proxy/client.go:75-79` — `NewGRPCClient` lets an app attach
over gRPC instead of the ordered socket protocol.  Here the transport is
real gRPC (HTTP/2, grpcio generic handlers — the same machinery as
`rpc/grpc_server.py`); request/response bodies reuse the framework's
deterministic ABCI wire codecs (`abci/wire.py`), so both transports share
one payload format and one server-side dispatch (`abci/server.dispatch`).

Method surface: /tendermint_tpu.ABCIApplication/<Name> with Name one of
Echo, Info, SetOption, InitChain, Query, BeginBlock, CheckTx, DeliverTx,
EndBlock, Commit.  Errors travel as gRPC aborts with the app's message.

Copy of `tendermint_tpu/abci/grpc_app.py`: the service name, method paths
and bodies are the JAX ones, so a port node attaches to a JAX app server
and a JAX node to a port one.  `grpc` is imported where a server or a
connection is built, never at import, and without grpcio that raises
`ImportError` naming it (`rpc.grpc_server.require_grpc`).
"""

from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor

from tendermint_tpu_torch.abci import wire
from tendermint_tpu_torch.abci.app import Application
from tendermint_tpu_torch.abci.server import dispatch
from tendermint_tpu_torch.abci.types import (RequestBeginBlock,
                                             ResponseEndBlock, ResponseInfo,
                                             ResponseQuery, Result)
from tendermint_tpu_torch.rpc.grpc_server import require_grpc
from tendermint_tpu_torch.types.codec import Reader, lp_bytes, u64
from tendermint_tpu_torch.utils.log import get_logger

log = get_logger("abci-grpc")

SERVICE = "tendermint_tpu.ABCIApplication"

_METHODS = {
    "Echo": wire.MSG_ECHO,
    "Info": wire.MSG_INFO,
    "SetOption": wire.MSG_SET_OPTION,
    "InitChain": wire.MSG_INIT_CHAIN,
    "Query": wire.MSG_QUERY,
    "BeginBlock": wire.MSG_BEGIN_BLOCK,
    "CheckTx": wire.MSG_CHECK_TX,
    "DeliverTx": wire.MSG_DELIVER_TX,
    "EndBlock": wire.MSG_END_BLOCK,
    "Commit": wire.MSG_COMMIT,
}


def _ident(b: bytes) -> bytes:
    return b


class GRPCABCIServer:
    """Serves an Application over gRPC (the app-process side)."""

    def __init__(self, app: Application, laddr: str = "tcp://127.0.0.1:0"):
        grpc = require_grpc(f"the ABCI gRPC server ({laddr})")
        self.app = app
        self._app_lock = threading.Lock()
        addr = laddr.replace("grpc://", "").replace("tcp://", "")
        self._server = grpc.server(ThreadPoolExecutor(8))
        outer = self

        class Handler(grpc.GenericRpcHandler):
            def service(self, handler_call_details):
                name = handler_call_details.method.rsplit("/", 1)[-1]
                msg_type = _METHODS.get(name)
                if (msg_type is None or not
                        handler_call_details.method.startswith(
                            f"/{SERVICE}/")):
                    return None
                return grpc.unary_unary_rpc_method_handler(
                    lambda req, ctx, mt=msg_type: outer._call(mt, req, ctx),
                    request_deserializer=_ident,
                    response_serializer=_ident)

        self._server.add_generic_rpc_handlers((Handler(),))
        self._port = self._server.add_insecure_port(addr)
        host = addr.rsplit(":", 1)[0]
        self.addr = f"grpc://{host}:{self._port}"

    def _call(self, msg_type: int, payload: bytes, ctx) -> bytes:
        resp_type, resp = dispatch(self.app, self._app_lock, msg_type,
                                   payload)
        if resp_type == wire.MSG_EXCEPTION:
            import grpc
            ctx.abort(grpc.StatusCode.INTERNAL,
                      Reader(resp).lp_bytes().decode())
        return resp

    def start(self) -> None:
        self._server.start()
        log.info("abci app serving over grpc", addr=self.addr)

    def stop(self) -> None:
        self._server.stop(grace=0.5)


class GRPCAppConn:
    """Node-side connection to a gRPC app — the AppConn interface
    (reference `proxy/client.go:75-79` NewGRPCClient).  Three of these
    share one HTTP/2 channel; the server's app lock serializes."""

    def __init__(self, channel, timeout: float = 10.0):
        # same deadline discipline as the socket transport
        # (abci/client.py): a hung app must surface as an error, not
        # wedge the consensus/mempool threads forever
        self._timeout = timeout
        self._fns = {
            name: channel.unary_unary(f"/{SERVICE}/{name}",
                                      request_serializer=_ident,
                                      response_deserializer=_ident)
            for name in _METHODS
        }

    def _call(self, name: str, payload: bytes = b"") -> bytes:
        import grpc
        from tendermint_tpu_torch.abci.client import ABCIClientError
        try:
            return self._fns[name](payload, timeout=self._timeout)
        except grpc.RpcError as e:
            raise ABCIClientError(e.details() if hasattr(e, "details")
                                  else str(e)) from None

    # -- the AppConn interface ------------------------------------------
    def echo(self, msg: bytes) -> bytes:
        return self._call("Echo", msg)

    def info(self) -> ResponseInfo:
        return wire.decode_response_info(self._call("Info"))

    def set_option(self, key: str, value: str) -> str:
        out = self._call("SetOption",
                         lp_bytes(key.encode()) + lp_bytes(value.encode()))
        return Reader(out).lp_bytes().decode()

    def init_chain(self, validators) -> None:
        self._call("InitChain", wire.encode_validators(validators))

    def query(self, data: bytes, path: str = "/", height: int = 0,
              prove: bool = False) -> ResponseQuery:
        return wire.decode_response_query(self._call(
            "Query", wire.encode_request_query(data, path, height, prove)))

    def begin_block(self, req: RequestBeginBlock) -> None:
        self._call("BeginBlock", wire.encode_request_begin_block(req))

    def check_tx(self, tx: bytes) -> Result:
        return Result.decode(Reader(self._call("CheckTx", lp_bytes(tx))))

    def deliver_tx(self, tx: bytes) -> Result:
        return Result.decode(Reader(self._call("DeliverTx", lp_bytes(tx))))

    def end_block(self, height: int) -> ResponseEndBlock:
        return wire.decode_response_end_block(
            self._call("EndBlock", u64(height)))

    def commit(self) -> Result:
        return Result.decode(Reader(self._call("Commit")))


def new_grpc_app_conns(addr: str):
    """Three logical connections to one gRPC app (mempool / consensus /
    query) multiplexed on one HTTP/2 channel."""
    grpc = require_grpc(f"ABCI over gRPC ({addr})")
    from tendermint_tpu_torch.proxy import AppConns
    target = addr.replace("grpc://", "")
    channel = grpc.insecure_channel(target)
    return AppConns(mempool=GRPCAppConn(channel),
                    consensus=GRPCAppConn(channel),
                    query=GRPCAppConn(channel))
