"""Utilities (counterpart of ``dgl_tpu/utils/``; reference
``python/dgl/utils/``)."""
from .checks import check_eq_shape, expand_as_pair
from .filter_mod import Filter
from .internal import relabel, toindex

__all__ = ["Filter", "expand_as_pair", "check_eq_shape", "toindex", "relabel"]
