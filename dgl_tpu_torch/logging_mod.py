"""Logging (counterpart of ``dgl_tpu/logging_mod.py``; reference
``python/dgl/logging.py``: logger "dgl-core" with the ``DGL_LOG_DEBUG``
toggle -> logger "dgl-tpu" with ``DGL_TPU_LOG_DEBUG``). Both packages log
under the same name."""
from __future__ import annotations

import logging
import os

__all__ = ["get_logger", "enable_verbose_logging"]

_logger = None


def get_logger() -> logging.Logger:
    global _logger
    if _logger is None:
        _logger = logging.getLogger("dgl-tpu")
        handler = logging.StreamHandler()
        handler.setFormatter(
            logging.Formatter(
                "%(asctime)s %(name)s %(levelname)s %(message)s"
            )
        )
        _logger.addHandler(handler)
        if os.environ.get("DGL_TPU_LOG_DEBUG", "").lower() in ("1", "true"):
            _logger.setLevel(logging.DEBUG)
        else:
            _logger.setLevel(logging.INFO)
    return _logger


def enable_verbose_logging():
    get_logger().setLevel(logging.DEBUG)
