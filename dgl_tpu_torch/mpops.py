"""Functional message-passing namespace (counterpart of
``dgl_tpu/mpops.py``; reference ``python/dgl/mpops/``: ``edgewise.py``,
``nodewise.py``, ``fused.py``): aliases over :mod:`dgl_tpu_torch.ops`."""
from __future__ import annotations

from . import ops

__all__ = [
    "copy_u_sum", "copy_u_mean", "copy_u_max", "copy_u_min",
    "copy_e_sum", "copy_e_mean", "copy_e_max", "copy_e_min",
    "u_add_v", "u_sub_v", "u_mul_v", "u_div_v", "u_dot_v",
    "u_mul_e_sum", "u_add_e_sum",
]

# nodewise/fused (reference mpops/nodewise.py, fused.py)
copy_u_sum = ops.copy_u_sum
copy_u_mean = ops.copy_u_mean
copy_u_max = ops.copy_u_max
copy_u_min = ops.copy_u_min
copy_e_sum = ops.copy_e_sum
copy_e_mean = ops.copy_e_mean
copy_e_max = ops.copy_e_max
copy_e_min = ops.copy_e_min
u_mul_e_sum = ops.u_mul_e_sum
u_add_e_sum = ops.u_add_e_sum

# edgewise (reference mpops/edgewise.py)
u_add_v = ops.u_add_v
u_sub_v = ops.u_sub_v
u_mul_v = ops.u_mul_v
u_div_v = ops.u_div_v
u_dot_v = ops.u_dot_v
