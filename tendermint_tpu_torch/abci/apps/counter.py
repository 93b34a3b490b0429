"""Counter app: ordered-nonce test application.

Reference: abci example counter (used in serial-tx tests,
`consensus/common_test.go:26-27`): with serial mode on, tx N must be the
big-endian encoding of N; CheckTx enforces nonce >= count, DeliverTx
enforces nonce == count.  Copy of `tendermint_tpu/abci/apps/counter.py`.
"""

from __future__ import annotations

from tendermint_tpu_torch.abci.app import Application, register_app
from tendermint_tpu_torch.abci.types import (ERR_BAD_NONCE, ERR_ENCODING,
                                             OK, ResponseInfo, ResponseQuery,
                                             Result)


class CounterApp(Application):
    def __init__(self, serial: bool = False):
        self.serial = serial
        self.hash_count = 0
        self.tx_count = 0

    def info(self) -> ResponseInfo:
        return ResponseInfo(
            data=f"{{\"hashes\":{self.hash_count},\"txs\":{self.tx_count}}}")

    def set_option(self, key: str, value: str) -> str:
        if key == "serial":
            self.serial = value == "on"
            return "ok"
        return ""

    def _nonce(self, tx: bytes) -> int | None:
        if len(tx) > 8:
            return None
        return int.from_bytes(tx, "big")

    def check_tx(self, tx: bytes) -> Result:
        if self.serial:
            n = self._nonce(tx)
            if n is None:
                return Result(ERR_ENCODING, log="tx too long")
            if n < self.tx_count:
                return Result(ERR_BAD_NONCE,
                              log=f"nonce {n} < count {self.tx_count}")
        return Result(OK)

    def deliver_tx(self, tx: bytes) -> Result:
        if self.serial:
            n = self._nonce(tx)
            if n is None:
                return Result(ERR_ENCODING, log="tx too long")
            if n != self.tx_count:
                return Result(ERR_BAD_NONCE,
                              log=f"nonce {n} != count {self.tx_count}")
        self.tx_count += 1
        return Result(OK)

    def commit(self) -> Result:
        self.hash_count += 1
        if self.tx_count == 0:
            return Result(OK)
        return Result(OK, data=self.tx_count.to_bytes(8, "big"))

    def query(self, data: bytes, path: str = "/", height: int = 0,
              prove: bool = False) -> ResponseQuery:
        if path == "/tx":
            return ResponseQuery(code=OK, value=str(self.tx_count).encode())
        return ResponseQuery(code=OK, value=str(self.hash_count).encode())


register_app("counter", CounterApp)
register_app("counter_serial", lambda: CounterApp(serial=True))
