"""Leveled runtime logging.

Replaces the reference's compile-time ``_LOG_INFO`` gated ``[INFO]`` couts
(``configure.ac:64-67`` and e.g. ``csr_matrix.tpp:16-35``) with a standard
runtime logger controllable via ``CFS_LOG`` / ``Config.log_info``.
"""

from __future__ import annotations

import logging
import sys

from .config import config

__all__ = ["get_logger", "info", "warn"]

_LOGGER = None


def get_logger() -> logging.Logger:
    global _LOGGER
    if _LOGGER is None:
        logger = logging.getLogger("cfs_spmv_tpu_torch")
        if not logger.handlers:
            h = logging.StreamHandler(sys.stderr)
            h.setFormatter(logging.Formatter("[%(levelname)s] cfs: %(message)s"))
            logger.addHandler(h)
        logger.setLevel(logging.INFO if config.log_info else logging.WARNING)
        _LOGGER = logger
    return _LOGGER


def info(msg: str, *args) -> None:
    get_logger().info(msg, *args)


def warn(msg: str, *args) -> None:
    get_logger().warning(msg, *args)
