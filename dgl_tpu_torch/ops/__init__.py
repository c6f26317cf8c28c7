"""Fused graph ops namespace (counterpart of ``dgl_tpu/ops/``)."""
from .spmm import *  # noqa: F401,F403
from .spmm import __all__
