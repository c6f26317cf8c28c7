"""SDDMM (counterpart of ``dgl_tpu/sparse/sddmm.py``; reference
``python/dgl/sparse/sddmm.py:10``): sampled dense-dense matmul, the value
at nnz (r, c) is ``<X1[r], X2[:, c]>``."""
from __future__ import annotations

from ..ops import gsddmm
from .sparse_matrix import SparseMatrix, _tensor, val_like

__all__ = ["sddmm", "bsddmm"]


def sddmm(A: SparseMatrix, X1, X2) -> SparseMatrix:
    """(reference ``sddmm.py:10``). X1 (n, d), X2 (d, m). Scalar values
    of ``A`` multiply the products (always: the reference never skips the
    multiply)."""
    dev = A.val.device
    X1, X2 = _tensor(X1, dev), _tensor(X2, dev)
    vals = gsddmm(A._rel, "dot", X1, X2.T, lhs_target="u", rhs_target="v")
    if vals.dim() > 1 and vals.shape[-1] == 1:
        vals = vals[..., 0]
    if A.val.dim() == 1:
        vals = vals * A.val
    return val_like(A, vals)


def bsddmm(A: SparseMatrix, X1, X2) -> SparseMatrix:
    """Batched sddmm (reference ``sddmm.py:69``): X1 (n, d, h),
    X2 (d, m, h) -> (nnz, h) values, every head in one g-SDDMM."""
    dev = A.val.device
    X1, X2 = _tensor(X1, dev), _tensor(X2, dev)
    vals = gsddmm(A._rel, "dot", X1.permute(0, 2, 1), X2.permute(1, 2, 0),
                  lhs_target="u", rhs_target="v")
    return val_like(A, vals[..., 0])
