"""gather_mm: per-row dense matmul with a per-row selected weight matrix
(counterpart of ``dgl_tpu/ops/gather_mm.py``; reference
``python/dgl/ops/gather_mm.py``), the kernel behind TypedLinear / R-GCN.

Plain PyTorch, as the JAX package has no Pallas kernel for it: the rows are
sorted by relation (a stable sort), multiplied segment by segment with
:func:`segment_mm`, and put back in their order.
"""
from __future__ import annotations

import torch

from .segment import segment_mm

__all__ = ["gather_mm"]


def gather_mm(a, b, idx_b):
    """``out[i] = a[i] @ b[idx_b[i]]`` (reference ``ops/gather_mm.py:8``).

    ``a``: (N, K); ``b``: (R, K, M); ``idx_b``: (N,) int. Returns (N, M) in
    ``a``'s dtype, the products in f32."""
    idx = idx_b.to(torch.int64)
    order = torch.sort(idx, stable=True).indices
    seglen = torch.bincount(idx, minlength=b.shape[0])
    out = segment_mm(a.index_select(0, order), b, seglen)
    return torch.empty_like(out).index_copy(0, order, out)
