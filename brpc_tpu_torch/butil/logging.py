"""glog-style logging facade (reference: src/butil/logging.h).

Thin shim over the stdlib ``logging`` module with the reference's line
format; the port logs at INFO, WARNING and ERROR.
"""
from __future__ import annotations

import logging as _pylog
import sys
import threading

_logger = _pylog.getLogger("brpc_tpu_torch")
if not _logger.handlers:
    _h = _pylog.StreamHandler(sys.stderr)
    _h.setFormatter(_pylog.Formatter(
        "%(levelname).1s%(asctime)s %(threadName)s %(filename)s:%(lineno)d] %(message)s",
        datefmt="%m%d %H:%M:%S"))
    _logger.addHandler(_h)
    _logger.setLevel(_pylog.INFO)

INFO = _pylog.INFO
WARNING = _pylog.WARNING
ERROR = _pylog.ERROR
FATAL = _pylog.CRITICAL

_every_n_counters: dict = {}
_every_n_lock = threading.Lock()


def log(level: int, msg: str, *args, **kw) -> None:
    _logger.log(level, msg, *args, stacklevel=2, **kw)


def info(msg: str, *args, **kw) -> None:
    _logger.info(msg, *args, stacklevel=2, **kw)


def warning(msg: str, *args, **kw) -> None:
    _logger.warning(msg, *args, stacklevel=2, **kw)


def error(msg: str, *args, **kw) -> None:
    _logger.error(msg, *args, stacklevel=2, **kw)


def fatal(msg: str, *args, **kw) -> None:
    """Log at FATAL and exit."""
    _logger.critical(msg, *args, stacklevel=2, **kw)
    raise SystemExit(msg % args if args else msg)


def log_every_n(level: int, n: int, msg: str, *args) -> None:
    """Reference LOG_EVERY_N: emit every n-th occurrence per call site."""
    import inspect
    frame = inspect.currentframe().f_back
    key = (frame.f_code.co_filename, frame.f_lineno)
    with _every_n_lock:
        c = _every_n_counters.get(key, 0)
        _every_n_counters[key] = c + 1
    if c % n == 0:
        _logger.log(level, msg, *args, stacklevel=2)


def set_min_log_level(level: int) -> None:
    _logger.setLevel(level)


def vlog_is_on(verbosity: int) -> bool:
    return _logger.isEnabledFor(_pylog.DEBUG)
