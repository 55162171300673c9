"""Structured logging: the JAX package's ``utils/logging_util.py`` with
this package's logger namespace. Standard ``logging``, no global
silencing of warnings."""
from __future__ import annotations

import logging
import sys

_ROOT = "option_pricing_ffn_lbfgs_tpu_torch"


def get_logger(name: str = "") -> logging.Logger:
    return logging.getLogger(f"{_ROOT}.{name}" if name else _ROOT)


def configure(level: int = logging.INFO, stream=sys.stderr) -> None:
    """Idempotent basic configuration for CLI entry points."""
    logger = logging.getLogger(_ROOT)
    if logger.handlers:
        return
    handler = logging.StreamHandler(stream)
    handler.setFormatter(logging.Formatter(
        "%(asctime)s %(name)s %(levelname)s %(message)s"))
    logger.addHandler(handler)
    logger.setLevel(level)
