"""ABCI application base class and the in-proc app registry.

Reference: the abci repo's Application interface (CheckTx / DeliverTx /
BeginBlock / EndBlock / Commit / Query / Info / InitChain) plus the
in-proc client creator table (`proxy/client.go:65-79`).  Copy of
`tendermint_tpu/abci/app.py` without the state-sync snapshot hooks.
"""

from __future__ import annotations

from tendermint_tpu_torch.abci.types import (OK, RequestBeginBlock, ResponseEndBlock,
                                       ResponseInfo, ResponseQuery, Result)


class Application:
    """Override what you need; defaults are no-ops that accept everything."""

    def info(self) -> ResponseInfo:
        return ResponseInfo()

    def set_option(self, key: str, value: str) -> str:
        return ""

    def init_chain(self, validators: list) -> None:
        pass

    def query(self, data: bytes, path: str = "/", height: int = 0,
              prove: bool = False) -> ResponseQuery:
        return ResponseQuery(code=OK)

    def check_tx(self, tx: bytes) -> Result:
        return Result(OK)

    def begin_block(self, req: RequestBeginBlock) -> None:
        pass

    def deliver_tx(self, tx: bytes) -> Result:
        return Result(OK)

    def end_block(self, height: int) -> ResponseEndBlock:
        return ResponseEndBlock()

    def commit(self) -> Result:
        """Returns the new app hash in `data`."""
        return Result(OK)


_REGISTRY: dict[str, type] = {}


def register_app(name: str, cls: type) -> None:
    _REGISTRY[name] = cls


def create_app(name: str) -> Application:
    """In-proc app by name (reference `proxy/client.go:65-79`)."""
    from tendermint_tpu_torch.abci.apps import kvstore  # noqa: F401 - registers
    if name not in _REGISTRY:
        raise ValueError(f"unknown in-proc app {name!r}; "
                         f"known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]()
