"""ABCI protocol types: the app <-> consensus contract.

Reference: abci v0.5.0 (`glide.yaml:21-25`) — Info / InitChain / Query /
BeginBlock / CheckTx / DeliverTx / EndBlock / Commit with result codes.
Kept as plain dataclasses; the socket protocol frames them with the codec
(`tendermint_tpu_torch.abci.wire`).
"""

from __future__ import annotations

from dataclasses import dataclass, field

OK = 0
ERR_ENCODING = 1
ERR_BAD_NONCE = 2
ERR_BAD_SIG = 3
# admission-control rejection (mempool/mempool.py): the pool (or the
# verify plane feeding it) is at capacity and the tx did not outrank
# anything evictable — a LOAD signal, not a verdict on the tx, so
# clients may back off and resubmit (the hash is NOT cached)
ERR_MEMPOOL_FULL = 4
ERR_UNKNOWN = 99


@dataclass
class Result:
    """Outcome of CheckTx/DeliverTx (reference abci Result)."""
    code: int = OK
    data: bytes = b""
    log: str = ""

    @property
    def is_ok(self) -> bool:
        return self.code == OK

    def encode(self) -> bytes:
        from tendermint_tpu_torch.types.codec import lp_bytes, u32
        return u32(self.code) + lp_bytes(self.data) + lp_bytes(
            self.log.encode())

    @classmethod
    def decode(cls, r) -> "Result":
        return cls(code=r.u32(), data=r.lp_bytes(), log=r.lp_bytes().decode())


@dataclass
class ResponseInfo:
    data: str = ""
    version: str = ""
    last_block_height: int = 0
    last_block_app_hash: bytes = b""


@dataclass
class ResponseQuery:
    code: int = OK
    index: int = -1
    key: bytes = b""
    value: bytes = b""
    proof: bytes = b""
    height: int = 0
    log: str = ""


@dataclass
class Validator:
    """Validator diff in EndBlock (pub_key, power); power 0 removes."""
    pub_key: bytes
    power: int


@dataclass
class ResponseEndBlock:
    diffs: list[Validator] = field(default_factory=list)


@dataclass
class RequestBeginBlock:
    hash: bytes
    header: object  # types.Header
