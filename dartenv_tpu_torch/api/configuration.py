"""Module-level logger setup (reference: `gym/configuration.py` † —
SURVEY.md §2.1 "Logging config"): a root handler for the package logger
plus `undo_logger_setup()` to detach it when embedding applications manage
logging themselves."""
from __future__ import annotations

import logging
import sys

logger = logging.getLogger("dartenv_tpu_torch")

_handler: logging.Handler | None = None


def logger_setup(level: int = logging.INFO) -> logging.Logger:
    """Attach a stderr handler to the package logger (idempotent)."""
    global _handler
    if _handler is None:
        _handler = logging.StreamHandler(sys.stderr)
        _handler.setFormatter(
            logging.Formatter("[%(asctime)s] %(name)s %(levelname)s: "
                              "%(message)s")
        )
        logger.addHandler(_handler)
    logger.setLevel(level)
    return logger


def undo_logger_setup() -> None:
    """Detach the package handler and stop filtering (reference
    `gym.undo_logger_setup()` † semantics: hand control back to the
    embedding application's logging config)."""
    global _handler
    if _handler is not None:
        logger.removeHandler(_handler)
        _handler = None
    logger.setLevel(logging.NOTSET)
