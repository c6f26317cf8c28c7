"""Base definitions (counterpart of ``dgl_tpu/base.py``)."""
from __future__ import annotations

import logging
import os
import warnings


class DGLError(Exception):
    """Framework error (reference ``python/dgl/base.py`` DGLError)."""


class DGLWarning(UserWarning):
    """Framework warning."""


class _All:
    """Sentinel selecting all nodes/edges (reference ``base.py`` ALL)."""

    _instance = None

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    def __repr__(self):
        return "ALL"


ALL = _All()

# type-id fields of to_homogeneous; original per-type ids
NTYPE = "_N"
ETYPE = "_E"
NID = "_ID"
EID = "_ID"


def is_all(arg) -> bool:
    return arg is ALL or (isinstance(arg, str) and arg == "__ALL__")


def dgl_warning(msg, category=DGLWarning, stacklevel=2):
    warnings.warn(msg, category=category, stacklevel=stacklevel)


def _get_logger():
    # the JAX package's logger: one name for both packages
    logger = logging.getLogger("dgl-tpu")
    if os.environ.get("DGL_LOG_DEBUG", "0") == "1":
        logger.setLevel(logging.DEBUG)
    return logger


logger = _get_logger()
