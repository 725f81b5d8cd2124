"""Structured logging for the port (PyTorch port of
:mod:`xmris_tpu.runtime.logging`).

A standard-library logger namespace (``xmris_tpu_torch.*``) with a concise
format, off by default (WARNING), switchable with one call.
"""

from __future__ import annotations

import logging

_FORMAT = "%(asctime)s %(levelname)-7s %(name)s :: %(message)s"


def get_logger(name: str = "xmris_tpu_torch") -> logging.Logger:
    """Namespace logger; children inherit the configured handler/level."""
    return logging.getLogger(name)


def set_log_level(level: str | int = "info", verbose: bool = True) -> None:
    """Configure the package logger (``set_log_level("info"|"error")``)."""
    logger = get_logger()
    if isinstance(level, str):
        level = getattr(logging, level.upper())
    if not logger.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(logging.Formatter(_FORMAT))
        logger.addHandler(handler)
    logger.setLevel(level)
    if verbose:
        logger.log(level, "log level set to %s", logging.getLevelName(level))
