"""Structured leveled kv logging.

Reference: tmlibs/log (structured kv logger) with per-module levels parsed
from a `log_level` spec like ``state:info,p2p:debug,*:error``
(reference `config/config.go:157-159`, `cmd/tendermint/commands/root.go:43-46`).

One line per record: ``HH:MM:SS.mmm LVL  module  message key=value ...``.
Level checks are two dict lookups — cheap enough for hot paths; formatting
only happens for records that pass the filter.

Copy of `tendermint_tpu/utils/log.py`: the same line for the same record,
module names and level spec.  Every module of the port logs through
`get_logger`, and the node applies `base.log_level` with `set_level_spec`.
"""

from __future__ import annotations

import sys
import threading
import time

DEBUG, INFO, WARN, ERROR, NONE = 10, 20, 30, 40, 100

_LEVELS = {"debug": DEBUG, "info": INFO, "warn": WARN, "error": ERROR,
           "none": NONE}
_NAMES = {DEBUG: "DBG", INFO: "INF", WARN: "WRN", ERROR: "ERR"}

_lock = threading.Lock()
_module_levels: dict[str, int] = {}
_default_level = INFO
_sink = None          # callable(str) or None -> stderr
_loggers: dict[str, "Logger"] = {}


def set_level_spec(spec: str) -> None:
    """Parse ``module:level,...`` with ``*`` as the default
    (e.g. ``consensus:debug,*:error``).  A bare level applies to all."""
    global _default_level
    with _lock:
        _module_levels.clear()
        for part in (spec or "").split(","):
            part = part.strip()
            if not part:
                continue
            if ":" in part:
                mod, _, lvl = part.partition(":")
                level = _LEVELS.get(lvl.strip().lower())
                if level is None:
                    raise ValueError(f"unknown log level {lvl!r}")
                if mod.strip() == "*":
                    _default_level = level
                else:
                    _module_levels[mod.strip()] = level
            else:
                level = _LEVELS.get(part.lower())
                if level is None:
                    raise ValueError(f"unknown log level {part!r}")
                _default_level = level


def set_sink(fn) -> None:
    """Redirect log output (tests, file sinks).  None = stderr."""
    global _sink
    _sink = fn


def _emit(line: str) -> None:
    sink = _sink
    if sink is not None:
        sink(line)
    else:
        print(line, file=sys.stderr, flush=True)


def _fmt_val(v) -> str:
    if isinstance(v, bytes):
        return v.hex()[:16]
    if isinstance(v, float):
        return f"{v:.4g}"
    s = str(v)
    if " " in s or "=" in s:
        return repr(s)
    return s


class Logger:
    __slots__ = ("module", "_bound")

    def __init__(self, module: str, bound: tuple = ()):
        self.module = module
        self._bound = bound

    def with_(self, **kv) -> "Logger":
        """A child logger with extra key=value context on every record."""
        return Logger(self.module, self._bound + tuple(kv.items()))

    def enabled(self, level: int) -> bool:
        return level >= _module_levels.get(self.module, _default_level)

    def _log(self, level: int, msg: str, kv: dict) -> None:
        if not self.enabled(level):
            return
        t = time.time()
        ms = int((t % 1) * 1000)
        stamp = time.strftime("%H:%M:%S", time.localtime(t))
        parts = [f"{stamp}.{ms:03d} {_NAMES[level]} {self.module:<10} {msg}"]
        for k, v in self._bound:
            parts.append(f"{k}={_fmt_val(v)}")
        for k, v in kv.items():
            parts.append(f"{k}={_fmt_val(v)}")
        _emit(" ".join(parts))

    def debug(self, msg: str, **kv) -> None:
        self._log(DEBUG, msg, kv)

    def info(self, msg: str, **kv) -> None:
        self._log(INFO, msg, kv)

    def warn(self, msg: str, **kv) -> None:
        self._log(WARN, msg, kv)

    def error(self, msg: str, **kv) -> None:
        self._log(ERROR, msg, kv)

    def exception(self, msg: str, **kv) -> None:
        """error + traceback of the active exception — the replacement for
        bare traceback.print_exc in must-not-die loops."""
        import traceback
        self._log(ERROR, msg, kv)
        if self.enabled(ERROR):
            _emit(traceback.format_exc().rstrip())


def get_logger(module: str) -> Logger:
    with _lock:
        lg = _loggers.get(module)
        if lg is None:
            lg = _loggers[module] = Logger(module)
        return lg
