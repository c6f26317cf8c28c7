"""Row and column broadcast ops (counterpart of
``dgl_tpu/sparse/broadcast.py``; reference
``python/dgl/sparse/broadcast.py``)."""
from __future__ import annotations

from ..base import DGLError
from .sparse_matrix import SparseMatrix, _tensor, val_like

__all__ = [
    "sp_broadcast_v", "sp_add_v", "sp_sub_v", "sp_mul_v", "sp_div_v",
]


def _rows_of(v, idx, n):
    """``v[idx]`` with the padded entries' out-of-range ids clamped to the
    last row, as the reference's gather clamps them."""
    return v[idx.long().clamp(max=max(n - 1, 0))]


def sp_broadcast_v(A: SparseMatrix, v, op: str) -> SparseMatrix:
    """Broadcast a dense vector along a sparse dim: ``v`` (n, 1) or (n,)
    row-wise, or (1, m) column-wise, applying ``op`` in {add, sub, mul,
    truediv}."""
    v = _tensor(v, A.val.device)
    if v.dim() == 1:
        v = v[:, None]
    n, m = A.shape
    if v.shape[0] == n and v.shape[1] in (1, *(tuple(A.val.shape[1:])
                                               or (1,))):
        per_nnz = _rows_of(v, A.row, n)
        if v.shape[1] == 1 and A.val.dim() == 1:
            per_nnz = per_nnz[:, 0]
    elif v.shape[0] == 1:
        if v.shape[1] != m:
            raise DGLError("bad broadcast shape")
        per_nnz = _rows_of(v[0], A.col, m)
    else:
        raise DGLError(f"cannot broadcast {tuple(v.shape)} to {A.shape}")
    if op == "add":
        return val_like(A, A.val + per_nnz)
    if op == "sub":
        return val_like(A, A.val - per_nnz)
    if op == "mul":
        return val_like(A, A.val * per_nnz)
    if op == "truediv":
        return val_like(A, A.val / per_nnz)
    raise DGLError(op)


def sp_add_v(A: SparseMatrix, v) -> SparseMatrix:
    """Reference ``python/dgl/sparse/broadcast.py:104``."""
    return sp_broadcast_v(A, v, "add")


def sp_sub_v(A: SparseMatrix, v) -> SparseMatrix:
    """Reference ``python/dgl/sparse/broadcast.py:112``."""
    return sp_broadcast_v(A, v, "sub")


def sp_mul_v(A: SparseMatrix, v) -> SparseMatrix:
    """Reference ``python/dgl/sparse/broadcast.py:120``."""
    return sp_broadcast_v(A, v, "mul")


def sp_div_v(A: SparseMatrix, v) -> SparseMatrix:
    """Reference ``python/dgl/sparse/broadcast.py:128``."""
    return sp_broadcast_v(A, v, "truediv")
