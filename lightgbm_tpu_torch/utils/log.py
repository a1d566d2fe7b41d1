"""Leveled logger with pluggable sink.

Reference: include/LightGBM/utils/log.h:81 (Log class, LogLevel, callback
sink log.h:83-90; Python redirection basic.py:48-108). Here it is a thin
wrapper over the stdlib logging module with the same level semantics:
Fatal raises, Warning/Info/Debug gated by verbosity.
"""

from __future__ import annotations

import logging
import sys
from typing import Callable, Optional

_logger = logging.getLogger("lightgbm_tpu_torch")
if not _logger.handlers:
    _h = logging.StreamHandler(sys.stderr)
    _h.setFormatter(logging.Formatter("[LightGBM-TPU-torch] [%(levelname)s] %(message)s"))
    _logger.addHandler(_h)
    _logger.setLevel(logging.INFO)

_custom_sink: Optional[Callable[[str], None]] = None


class LightGBMError(Exception):
    """Fatal error raised by Log.fatal (reference log.h:110 raises)."""


def register_logger(logger_or_callback) -> None:
    """Redirect log output (reference LGBM_RegisterLogCallback c_api.h:71)."""
    global _custom_sink, _logger
    if callable(logger_or_callback) and not isinstance(
            logger_or_callback, logging.Logger):
        _custom_sink = logger_or_callback
    elif isinstance(logger_or_callback, logging.Logger):
        _logger = logger_or_callback
        _custom_sink = None


class Log:
    verbosity: int = 1  # <0: fatal only, 0: +warn, 1: +info, >1: +debug

    @staticmethod
    def set_verbosity(v: int) -> None:
        Log.verbosity = v

    @staticmethod
    def _emit(level: int, msg: str) -> None:
        if _custom_sink is not None:
            _custom_sink(msg + "\n")
        else:
            _logger.log(level, msg)

    @staticmethod
    def debug(msg: str, *args) -> None:
        if Log.verbosity > 1:
            Log._emit(logging.DEBUG, msg % args if args else msg)

    @staticmethod
    def info(msg: str, *args) -> None:
        if Log.verbosity >= 1:
            Log._emit(logging.INFO, msg % args if args else msg)

    @staticmethod
    def warning(msg: str, *args) -> None:
        if Log.verbosity >= 0:
            Log._emit(logging.WARNING, msg % args if args else msg)

    @staticmethod
    def fatal(msg: str, *args) -> None:
        text = msg % args if args else msg
        Log._emit(logging.ERROR, text)
        raise LightGBMError(text)
