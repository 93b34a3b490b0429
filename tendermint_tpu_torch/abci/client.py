"""Socket ABCI client: the node side of an out-of-process app.

Reference: abci socket client (`proxy/client.go:74-79`).  The node gets
three independent connections (mempool / consensus / query) so CheckTx
traffic never queues behind block execution — the same isolation the
reference's multiAppConn provides (`proxy/multi_app_conn.go:71-110`).  Copy of `tendermint_tpu/abci/client.py`.
"""

from __future__ import annotations

import socket
import threading

from tendermint_tpu_torch.abci import wire
from tendermint_tpu_torch.abci.types import (RequestBeginBlock,
                                             ResponseEndBlock, ResponseInfo,
                                             ResponseQuery, Result)
from tendermint_tpu_torch.types.codec import Reader, lp_bytes, u64
from tendermint_tpu_torch.utils.log import get_logger

log = get_logger("abci")


class ABCIClientError(Exception):
    pass


class SocketAppConn:
    """One connection; request/response serialized by a lock.  `name`
    identifies which of the three proxy connections this is (mempool /
    consensus / query) so a dead socket's errors say which plane died."""

    def __init__(self, addr: str, timeout: float = 10.0, name: str = ""):
        if not addr.startswith("tcp://"):
            raise ValueError(f"ABCI app address must be tcp://: {addr!r}")
        self.name = name or addr
        host, port = addr[6:].rsplit(":", 1)
        self._sock = socket.create_connection((host, int(port)),
                                              timeout=timeout)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._lock = threading.Lock()

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError as e:
            # close failures can't be retried, but a socket that won't
            # even close is worth a breadcrumb when the app misbehaves
            log.debug("abci conn close failed", conn=self.name, err=str(e))

    def _call(self, msg_type: int, payload: bytes = b"") -> bytes:
        try:
            with self._lock:
                wire.write_frame(self._sock, msg_type, payload)
                resp_type, resp = wire.read_frame(self._sock)
        except (OSError, EOFError) as e:
            # name the plane and the request: "consensus conn died on
            # msg 0x12" localizes an app crash to the exact call
            raise ABCIClientError(
                f"abci {self.name} connection failed on request "
                f"type {msg_type}: {type(e).__name__}: {e}") from e
        if resp_type == wire.MSG_EXCEPTION:
            raise ABCIClientError(Reader(resp).lp_bytes().decode())
        if resp_type != msg_type:
            raise ABCIClientError(
                f"response type {resp_type} != request {msg_type}")
        return resp

    # -- the AppConn interface ------------------------------------------
    def echo(self, msg: bytes) -> bytes:
        return self._call(wire.MSG_ECHO, msg)

    def info(self) -> ResponseInfo:
        return wire.decode_response_info(self._call(wire.MSG_INFO))

    def set_option(self, key: str, value: str) -> str:
        out = self._call(wire.MSG_SET_OPTION,
                         lp_bytes(key.encode()) + lp_bytes(value.encode()))
        return Reader(out).lp_bytes().decode()

    def init_chain(self, validators) -> None:
        self._call(wire.MSG_INIT_CHAIN, wire.encode_validators(validators))

    def query(self, data: bytes, path: str = "/", height: int = 0,
              prove: bool = False) -> ResponseQuery:
        return wire.decode_response_query(self._call(
            wire.MSG_QUERY,
            wire.encode_request_query(data, path, height, prove)))

    def begin_block(self, req: RequestBeginBlock) -> None:
        self._call(wire.MSG_BEGIN_BLOCK, wire.encode_request_begin_block(req))

    def check_tx(self, tx: bytes) -> Result:
        return Result.decode(Reader(self._call(wire.MSG_CHECK_TX,
                                               lp_bytes(tx))))

    def deliver_tx(self, tx: bytes) -> Result:
        return Result.decode(Reader(self._call(wire.MSG_DELIVER_TX,
                                               lp_bytes(tx))))

    def end_block(self, height: int) -> ResponseEndBlock:
        return wire.decode_response_end_block(
            self._call(wire.MSG_END_BLOCK, u64(height)))

    def commit(self) -> Result:
        return Result.decode(Reader(self._call(wire.MSG_COMMIT)))


def new_socket_app_conns(addr: str):
    """Three sockets to one app server (mempool / consensus / query)."""
    from tendermint_tpu_torch.proxy import AppConns
    return AppConns(mempool=SocketAppConn(addr, name="mempool"),
                    consensus=SocketAppConn(addr, name="consensus"),
                    query=SocketAppConn(addr, name="query"))
