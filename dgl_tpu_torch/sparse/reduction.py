"""Reductions over sparse dims (counterpart of
``dgl_tpu/sparse/reduction.py``; reference
``python/dgl/sparse/reduction.py``).

Per-row and per-column reductions scatter the real entries only (a padded
entry's row is out of range and the reference's scatter drops it);
``dim=None`` reduces every stored value, the padded ones too, as the
reference does.
"""
from __future__ import annotations

import torch

from ..base import DGLError
from .sparse_matrix import SparseMatrix

__all__ = ["reduce", "sum", "smax", "smin", "smean", "sprod"]


def _extreme_fill(dtype, largest: bool):
    """The empty reduction's value: -inf for a max, +inf for a min (the
    integer limits for integer values)."""
    if dtype.is_floating_point:
        return -torch.inf if largest else torch.inf
    info = torch.iinfo(dtype)
    return info.min if largest else info.max


def _segments(A: SparseMatrix, dim):
    """The real entries' values, their segment ids and the segment count."""
    E = A.nnz
    seg = (A.col if dim == 0 else A.row)[:E].long()
    n = A.shape[1] if dim == 0 else A.shape[0]
    return A.val[:E], seg, n


def _scatter(v, seg, n, how: str, init):
    idx = seg.reshape((-1,) + (1,) * (v.dim() - 1)).expand_as(v)
    out = v.new_full((n,) + tuple(v.shape[1:]), init)
    return out.scatter_reduce(0, idx, v, how, include_self=how == "prod")


def reduce(A: SparseMatrix, op: str = "sum", dim=None):
    """``op`` in {sum, smax, smin, smean, sprod}; ``dim`` None reduces all
    nnz, 0 over rows (a result per column), 1 over columns (per row).
    Rows or columns without an entry give 0."""
    v = A.val
    if dim is None:
        if op == "sum":
            return v.sum(0)
        if op == "smax":
            return v.amax(0)
        if op == "smin":
            return v.amin(0)
        if op == "smean":
            return v.mean(0)
        if op == "sprod":
            return v.prod(0)
        raise DGLError(op)
    v, seg, n = _segments(A, dim)
    shape = (n,) + tuple(v.shape[1:])
    if op == "sum":
        return v.new_zeros(shape).index_add(0, seg, v)
    if op in ("smax", "smin"):
        out = _scatter(v, seg, n, "amax" if op == "smax" else "amin",
                       _extreme_fill(v.dtype, op == "smax"))
        return torch.where(torch.isfinite(out), out, 0)
    if op == "smean":
        s = v.new_zeros(shape).index_add(0, seg, v)
        c = v.new_zeros((n,) + (1,) * (v.dim() - 1)).index_add(
            0, seg, v.new_ones((seg.shape[0],) + (1,) * (v.dim() - 1)))
        return s / torch.clamp(c, min=1)
    if op == "sprod":
        out = _scatter(v, seg, n, "prod", 1)
        # rows/cols with no nnz reduce to 0, as in the reference
        # (``python/dgl/sparse/reduction.py:321``: sprod of empty = 0)
        has = torch.bincount(seg, minlength=n) > 0
        return torch.where(has.reshape((n,) + (1,) * (v.dim() - 1)), out, 0)
    raise DGLError(op)


def sum(A: SparseMatrix, dim=None):  # noqa: A001 - reference name
    """Reference ``python/dgl/sparse/reduction.py:85``."""
    return reduce(A, "sum", dim)


def smax(A: SparseMatrix, dim=None):
    """Reference ``python/dgl/sparse/reduction.py:139``."""
    return reduce(A, "smax", dim)


def smin(A: SparseMatrix, dim=None):
    """Reference ``python/dgl/sparse/reduction.py:197``."""
    return reduce(A, "smin", dim)


def smean(A: SparseMatrix, dim=None):
    """Reference ``python/dgl/sparse/reduction.py:259``."""
    return reduce(A, "smean", dim)


def sprod(A: SparseMatrix, dim=None):
    """Reference ``python/dgl/sparse/reduction.py:321``."""
    return reduce(A, "sprod", dim)
