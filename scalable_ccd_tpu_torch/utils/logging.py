"""Logging singleton (copy of ``scalable_ccd_tpu/utils/logging.py``).

Counterpart of the reference's spdlog singleton
(``src/scalable_ccd/utils/logger.hpp:13-18``, ``logger.cpp:21-39``): a single
named logger ``"ccd"`` with a user-overridable handler via :func:`set_logger`.
Level discipline mirrors the reference (trace -> DEBUG-5, debug, warn, error).
"""

from __future__ import annotations

import logging

_LOGGER_NAME = "ccd"
_logger: logging.Logger | None = None

#: spdlog has a TRACE level below DEBUG; Python doesn't, so register one.
TRACE = 5
logging.addLevelName(TRACE, "TRACE")


def logger() -> logging.Logger:
    """Return the library logger, creating a default one on first use."""
    global _logger
    if _logger is None:
        log = logging.getLogger(_LOGGER_NAME)
        if not log.handlers:
            handler = logging.StreamHandler()
            handler.setFormatter(
                logging.Formatter("[%(asctime)s] [%(name)s] [%(levelname)s] %(message)s")
            )
            log.addHandler(handler)
        log.setLevel(logging.WARNING)
        _logger = log
    return _logger


def set_logger(new_logger: logging.Logger) -> None:
    """Replace the library logger (reference: ``set_logger``, logger.hpp:18)."""
    global _logger
    _logger = new_logger


def trace(msg: str, *args) -> None:
    logger().log(TRACE, msg, *args)
