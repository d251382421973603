"""glog-style logging facade (reference: src/butil/logging.h).

Thin shim over the stdlib ``logging`` module with the reference's line
format; the port logs at INFO, WARNING and ERROR.
"""
from __future__ import annotations

import logging as _pylog
import sys

_logger = _pylog.getLogger("brpc_tpu_torch")
if not _logger.handlers:
    _h = _pylog.StreamHandler(sys.stderr)
    _h.setFormatter(_pylog.Formatter(
        "%(levelname).1s%(asctime)s %(threadName)s %(filename)s:%(lineno)d] %(message)s",
        datefmt="%m%d %H:%M:%S"))
    _logger.addHandler(_h)
    _logger.setLevel(_pylog.INFO)


def info(msg: str, *args, **kw) -> None:
    _logger.info(msg, *args, stacklevel=2, **kw)


def warning(msg: str, *args, **kw) -> None:
    _logger.warning(msg, *args, stacklevel=2, **kw)


def error(msg: str, *args, **kw) -> None:
    _logger.error(msg, *args, stacklevel=2, **kw)
