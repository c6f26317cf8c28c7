"""Fused graph ops namespace (counterpart of ``dgl_tpu/ops/``).

The bitmap modules are exported as modules (``ops.bitmap_gat.bitmap_gat``,
as in the reference, keeps the function from shadowing its module)."""
from . import bitmap_gat, bitmap_spmm
from .bitmap_spmm import BitmapPlan, bitmap_copy_u_sum, build_bitmap_plan
from .spmm import *  # noqa: F401,F403
from .spmm import __all__ as _spmm_all

__all__ = list(_spmm_all) + ["BitmapPlan", "bitmap_copy_u_sum",
                             "bitmap_gat", "bitmap_spmm",
                             "build_bitmap_plan"]
