"""Socket ABCI framing: length-prefixed request/response records.

Reference: the abci repo's socket protocol (varint-prefixed protobuf).
This framework frames with the deterministic codec instead: every message
is u32(len) || u8(msg_type) || payload.  One request, one response, in
order, per connection — the node opens three connections (mempool /
consensus / query) so the pipelines never block each other (reference
`proxy/multi_app_conn.go:71-110`).  Copy of `tendermint_tpu/abci/wire.py`:
the same bytes on the wire, so a port node serves a JAX app and the other
way round.
"""

from __future__ import annotations

import socket
import struct

from tendermint_tpu_torch.abci.types import (RequestBeginBlock, ResponseEndBlock,
                                       ResponseInfo, ResponseQuery,
                                       Validator)
from tendermint_tpu_torch.types.block import Header
from tendermint_tpu_torch.types.codec import Reader, i64, lp_bytes, u32, u64, u8

# message types (request and response share the type byte)
MSG_ECHO = 0x01
MSG_INFO = 0x02
MSG_SET_OPTION = 0x03
MSG_INIT_CHAIN = 0x04
MSG_QUERY = 0x05
MSG_BEGIN_BLOCK = 0x06
MSG_CHECK_TX = 0x07
MSG_DELIVER_TX = 0x08
MSG_END_BLOCK = 0x09
MSG_COMMIT = 0x0A
MSG_EXCEPTION = 0x3F


def write_frame(sock: socket.socket, msg_type: int, payload: bytes) -> None:
    sock.sendall(struct.pack(">IB", len(payload) + 1, msg_type) + payload)


def read_frame(sock: socket.socket) -> tuple[int, bytes]:
    hdr = _read_exact(sock, 5)
    ln, msg_type = struct.unpack(">IB", hdr)
    payload = _read_exact(sock, ln - 1)
    return msg_type, payload


def _read_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("abci connection closed")
        buf += chunk
    return buf


# -- payload codecs --------------------------------------------------------

def encode_response_info(r: ResponseInfo) -> bytes:
    return (lp_bytes(r.data.encode()) + lp_bytes(r.version.encode()) +
            u64(r.last_block_height) + lp_bytes(r.last_block_app_hash))


def decode_response_info(b: bytes) -> ResponseInfo:
    r = Reader(b)
    return ResponseInfo(data=r.lp_bytes().decode(),
                        version=r.lp_bytes().decode(),
                        last_block_height=r.u64(),
                        last_block_app_hash=r.lp_bytes())


def encode_response_query(q: ResponseQuery) -> bytes:
    return (u32(q.code) + i64(q.index) + lp_bytes(q.key) +
            lp_bytes(q.value) + lp_bytes(q.proof) + u64(q.height) +
            lp_bytes(q.log.encode()))


def decode_response_query(b: bytes) -> ResponseQuery:
    r = Reader(b)
    return ResponseQuery(code=r.u32(), index=r.i64(), key=r.lp_bytes(),
                         value=r.lp_bytes(), proof=r.lp_bytes(),
                         height=r.u64(), log=r.lp_bytes().decode())


def encode_request_query(data: bytes, path: str, height: int,
                         prove: bool) -> bytes:
    return (lp_bytes(data) + lp_bytes(path.encode()) + u64(height) +
            u8(1 if prove else 0))


def decode_request_query(b: bytes) -> tuple:
    r = Reader(b)
    return r.lp_bytes(), r.lp_bytes().decode(), r.u64(), bool(r.u8())


def encode_validators(vals: list[Validator]) -> bytes:
    out = u32(len(vals))
    for v in vals:
        out += lp_bytes(v.pub_key) + i64(v.power)
    return out


def decode_validators(r: Reader) -> list[Validator]:
    return [Validator(pub_key=r.lp_bytes(), power=r.i64())
            for _ in range(r.u32())]


def encode_request_begin_block(req: RequestBeginBlock) -> bytes:
    return lp_bytes(req.hash) + lp_bytes(req.header.encode())


def decode_request_begin_block(b: bytes) -> RequestBeginBlock:
    r = Reader(b)
    h = r.lp_bytes()
    header = Header.decode(Reader(r.lp_bytes()))
    return RequestBeginBlock(hash=h, header=header)


def encode_response_end_block(e: ResponseEndBlock) -> bytes:
    return encode_validators(e.diffs)


def decode_response_end_block(b: bytes) -> ResponseEndBlock:
    return ResponseEndBlock(diffs=decode_validators(Reader(b)))
