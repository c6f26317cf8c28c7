"""Sparse softmax (counterpart of ``dgl_tpu/sparse/softmax_mod.py``;
reference ``python/dgl/sparse/softmax.py``): softmax of the nnz values
along a sparse dimension (1 = over each row's entries).

A row whose maximum is not finite is shifted by 0, and the sum is floored
at 1e-38, as in the reference. The maxima and sums scatter the real
entries only; every entry, a padded one too, reads its row's through a
gather that clamps the padded entries' out-of-range row to the last row,
the reference's values there.
"""
from __future__ import annotations

import torch

from .reduction import _extreme_fill, _scatter
from .sparse_matrix import SparseMatrix, val_like

__all__ = ["softmax"]


def _segment_softmax(val, seg, n: int, E: int):
    m = _scatter(val[:E], seg[:E], n, "amax", _extreme_fill(val.dtype, True))
    m = torch.where(torch.isfinite(m), m, 0.0)
    at = seg.clamp(max=max(n - 1, 0))
    e = torch.exp(val - m[at])
    s = e.new_zeros(m.shape).index_add(0, seg[:E], e[:E])
    return e / torch.clamp(s[at], min=1e-38)


def softmax(A: SparseMatrix, dim: int = 1) -> SparseMatrix:
    """dim=1: softmax over each row; dim=0: over each column. Vector values
    take a softmax per column of ``val``."""
    seg = (A.row if dim == 1 else A.col).long()
    n = A.shape[0] if dim == 1 else A.shape[1]
    return val_like(A, _segment_softmax(A.val, seg, n, A.nnz))
