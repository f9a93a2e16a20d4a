"""Leveled, coloured console logging.

Counterpart of ``ray_tracing_octrees_tpu/utils/logging.py``: the
framework-wide replacement for the reference's fmt/vivid logger
(Log.h:1-61) and scattered std::cout. The level comes from
``RTO_LOG_LEVEL`` (default INFO); colour only on a terminal.
"""

from __future__ import annotations

import logging
import os
import sys

_COLORS = {
    "DEBUG": "\x1b[36m",
    "INFO": "\x1b[32m",
    "WARNING": "\x1b[33m",
    "ERROR": "\x1b[31m",
}
_RESET = "\x1b[0m"


class _ColorFormatter(logging.Formatter):
    def format(self, record):
        base = super().format(record)
        if sys.stderr.isatty():
            color = _COLORS.get(record.levelname, "")
            return f"{color}{base}{_RESET}"
        return base


def get_logger(name: str = "rto") -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        h = logging.StreamHandler()
        h.setFormatter(_ColorFormatter("[%(levelname)s] %(name)s: %(message)s"))
        logger.addHandler(h)
        logger.setLevel(os.environ.get("RTO_LOG_LEVEL", "INFO").upper())
        logger.propagate = False
    return logger
