"""Process-global logger.

Replaces the reference's zap singleton (reference: logger/logger.go:1-45):
lazy default construction, level set from config, and a monotonically
increasing transaction id for request logs (reference: server/server.go:14).
"""
from __future__ import annotations

import itertools
import logging
import sys
import threading

_LOCK = threading.Lock()
_LOGGER: logging.Logger | None = None
_TXID = itertools.count(1)

_FORMAT = "%(asctime)s\t%(levelname)s\t%(name)s\t%(message)s"

LEVELS = {
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warn": logging.WARNING,
    "warning": logging.WARNING,
    "error": logging.ERROR,
    "none": logging.CRITICAL + 10,
}


def configure(level: str = "info") -> logging.Logger:
    """Initialise the global logger at the given level (idempotent)."""
    global _LOGGER
    with _LOCK:
        logger = logging.getLogger("vectorsearch")
        logger.setLevel(LEVELS.get(level.lower(), logging.INFO))
        if not logger.handlers:
            handler = logging.StreamHandler(sys.stderr)
            handler.setFormatter(logging.Formatter(_FORMAT))
            logger.addHandler(handler)
        logger.propagate = False
        _LOGGER = logger
        return logger


def sugar() -> logging.Logger:
    """Return the global logger, creating a default-level one if needed."""
    if _LOGGER is None:
        return configure()
    return _LOGGER


def next_txid() -> int:
    """Next request transaction id (atomic counter)."""
    return next(_TXID)
