"""gRPC broadcast API — the reference's second RPC surface.

Reference: `rpc/grpc/api.go:14-32` + `rpc/grpc/client_server.go`: a tiny
gRPC service (`Ping`, `BroadcastTx`) next to the JSON-RPC server, served
when `rpc.grpc_laddr` is configured.  Real gRPC (HTTP/2) transport via
grpcio generic handlers; message bodies use the framework's fixed-layout
binary codec (`types.codec`) rather than generated protobuf stubs — the
same in-repo codec every other wire surface uses, so there is no
generated-code bulk to vendor.

Wire formats:
  Ping:        request b"" -> response b""
  BroadcastTx: request  lp_bytes(tx)
               response u32(check_code) lp(check_data) lp(check_log)
                        u32(deliver_code) lp(deliver_data) lp(deliver_log)

Copy of `tendermint_tpu/rpc/grpc_server.py`: the service name, method
paths and bodies are the JAX ones, so either package's client talks to
either package's server.  `BroadcastTx` answers through the node's
`broadcast_tx_commit` route (CheckTx, kernel K5 on a `CudaBackend`, then
the DeliverTx event).  `grpc` is imported where a server or client is
built, never at import; without grpcio that raises `ImportError` naming
it (`require_grpc`), and the node refuses `rpc.grpc_laddr` at start.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

from tendermint_tpu_torch.types.codec import Reader, lp_bytes, u32
from tendermint_tpu_torch.utils.log import get_logger

log = get_logger("grpc")

SERVICE = "tendermint_tpu.BroadcastAPI"


def require_grpc(what: str):
    """The `grpc` module, or `ImportError` naming grpcio and `what` needs
    it for."""
    try:
        import grpc
    except ImportError as e:
        raise ImportError(f"{what} needs grpcio, which is not installed "
                          f"here: {e}") from e
    return grpc


def _ident(b: bytes) -> bytes:
    return b


def _encode_result(d: dict) -> bytes:
    check = d.get("check_tx") or {}
    deliver = d.get("deliver_tx") or {}

    def enc(r: dict) -> bytes:
        return (u32(int(r.get("code", 0))) +
                lp_bytes(bytes.fromhex(r.get("data", "") or "")) +
                lp_bytes((r.get("log", "") or "").encode()))

    return enc(check) + enc(deliver)


def decode_result(b: bytes) -> dict:
    r = Reader(b)

    def dec() -> dict:
        return {"code": r.u32(), "data": r.lp_bytes().hex(),
                "log": r.lp_bytes().decode()}

    check = dec()
    deliver = dec()
    r.expect_done()
    return {"check_tx": check, "deliver_tx": deliver}


class GRPCServer:
    """Serves Ping/BroadcastTx over gRPC next to the JSON-RPC server."""

    def __init__(self, routes, laddr: str):
        grpc = require_grpc(f"the gRPC broadcast API ({laddr})")
        self._routes = routes
        addr = laddr.replace("tcp://", "")
        self._server = grpc.server(ThreadPoolExecutor(4))

        outer = self

        class Handler(grpc.GenericRpcHandler):
            def service(self, handler_call_details):
                name = handler_call_details.method
                if name == f"/{SERVICE}/Ping":
                    return grpc.unary_unary_rpc_method_handler(
                        lambda req, ctx: b"",
                        request_deserializer=_ident,
                        response_serializer=_ident)
                if name == f"/{SERVICE}/BroadcastTx":
                    return grpc.unary_unary_rpc_method_handler(
                        outer._broadcast_tx,
                        request_deserializer=_ident,
                        response_serializer=_ident)
                return None

        self._server.add_generic_rpc_handlers((Handler(),))
        self._port = self._server.add_insecure_port(addr)
        self.laddr = addr.rsplit(":", 1)[0] + f":{self._port}"

    def _broadcast_tx(self, req: bytes, ctx) -> bytes:
        tx = Reader(req).lp_bytes()
        res = self._routes.broadcast_tx_commit({"tx": "0x" + tx.hex()})
        return _encode_result(res)

    def start(self) -> None:
        self._server.start()
        log.info("grpc broadcast api serving", laddr=self.laddr)

    def stop(self) -> None:
        self._server.stop(grace=0.5)


class GRPCClient:
    """Minimal client for the broadcast API (reference
    `rpc/grpc/client_server.go` StartGRPCClient)."""

    def __init__(self, addr: str):
        grpc = require_grpc("the gRPC broadcast client")
        addr = addr.replace("tcp://", "")
        self._chan = grpc.insecure_channel(addr)
        self._ping = self._chan.unary_unary(
            f"/{SERVICE}/Ping", request_serializer=_ident,
            response_deserializer=_ident)
        self._btx = self._chan.unary_unary(
            f"/{SERVICE}/BroadcastTx", request_serializer=_ident,
            response_deserializer=_ident)

    def ping(self) -> bool:
        return self._ping(b"") == b""

    def broadcast_tx(self, tx: bytes) -> dict:
        return decode_result(self._btx(lp_bytes(tx)))

    def close(self) -> None:
        self._chan.close()
