"""Colored logging helper (counterpart of mxtpu/log.py; parity:
python/mxnet/log.py — get_logger with
the single-letter level label + ANSI color formatter the reference ships)."""
from __future__ import annotations

import logging
import sys

CRITICAL = logging.CRITICAL
ERROR = logging.ERROR
WARNING = logging.WARNING
INFO = logging.INFO
DEBUG = logging.DEBUG
NOTSET = logging.NOTSET

_LABELS = {logging.CRITICAL: "C", logging.ERROR: "E", logging.WARNING: "W",
           logging.INFO: "I", logging.DEBUG: "D"}


class _Formatter(logging.Formatter):
    """'L MMDD HH:MM:SS name] message', colored when attached to a tty."""

    def __init__(self, colored=True):
        super().__init__(datefmt="%m%d %H:%M:%S")
        self._colored = colored

    def format(self, record):
        label = _LABELS.get(record.levelno, "U")
        head = "%s %s %s]" % (label, self.formatTime(record, self.datefmt),
                              record.name)
        if self._colored:
            color = "\x1b[31m" if record.levelno >= logging.WARNING else \
                "\x1b[32m" if record.levelno >= logging.INFO else "\x1b[34m"
            head = color + head + "\x1b[0m"
        out = "%s %s" % (head, record.getMessage())
        if record.exc_info:
            out += "\n" + self.formatException(record.exc_info)
        if record.stack_info:
            out += "\n" + self.formatStack(record.stack_info)
        return out


def get_logger(name=None, filename=None, filemode=None, level=WARNING):
    """Return a logger configured with the mx formatter (reference
    log.getLogger semantics: a file handler when ``filename`` is given,
    else a stderr stream handler; idempotent per logger)."""
    logger = logging.getLogger(name)
    if getattr(logger, "_mxtpu_configured", False):
        logger.setLevel(level)
        return logger
    if filename:
        handler = logging.FileHandler(filename, filemode or "a")
        handler.setFormatter(_Formatter(colored=False))
    else:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(_Formatter(
            colored=getattr(sys.stderr, "isatty", lambda: False)()))
    logger.addHandler(handler)
    logger.setLevel(level)
    logger._mxtpu_configured = True
    return logger
