"""Fused graph ops namespace (counterpart of ``dgl_tpu/ops/``).

The namespace of ``dgl_tpu.ops``: the generated g-SpMM names, the
generated g-SDDMM names (``u_add_v``, ``u_dot_v``, ..., ``copy_u``,
``copy_v``) except those that clash with g-SpMM's, ``gsddmm``,
``edge_softmax``, the segment ops, ``gather_mm`` and the opt-in hub cache
(``ops.hub_cache``). The bitmap modules are exported as modules
(``ops.bitmap_gat.bitmap_gat``, as in the reference, keeps the function
from shadowing its module)."""
import sys as _sys

from . import bitmap_gat, bitmap_spmm, hub_cache
from . import sddmm as _sddmm
from .bitmap_spmm import BitmapPlan, bitmap_copy_u_sum, build_bitmap_plan
from .edge_softmax import edge_softmax
from .gather_mm import gather_mm
from .sddmm import gsddmm
from .segment import segment_mm, segment_reduce, segment_softmax
from .spmm import *  # noqa: F401,F403
from .spmm import __all__ as _spmm_all

_mod = _sys.modules[__name__]
for _name in _sddmm.__all__:
    if not hasattr(_mod, _name):
        setattr(_mod, _name, getattr(_sddmm, _name))

__all__ = sorted(set(_spmm_all) | set(_sddmm.__all__) | {
    "edge_softmax", "segment_reduce", "segment_softmax", "segment_mm",
    "gather_mm", "gsddmm", "gspmm", "hub_cache", "BitmapPlan",
    "bitmap_copy_u_sum", "bitmap_gat", "bitmap_spmm", "build_bitmap_plan"})
