"""Unary ops (counterpart of ``dgl_tpu/sparse/unary.py``; reference
``python/dgl/sparse/unary.py``)."""
from .sparse_matrix import SparseMatrix, val_like

__all__ = ["neg"]


def neg(A: SparseMatrix) -> SparseMatrix:
    return val_like(A, -A.val)
