"""Sparse matmuls (counterpart of ``dgl_tpu/sparse/matmul.py``; reference
``python/dgl/sparse/matmul.py:12,50,88``)."""
from __future__ import annotations

import numpy as np

from ..base import DGLError
from ..ops import gspmm
from .sparse_matrix import SparseMatrix, _tensor, from_coo

__all__ = ["spmm", "bspmm", "spspmm", "matmul"]


def spmm(A: SparseMatrix, X):
    """Dense = Sparse @ Dense (reference ``matmul.py:12``).

    A (n, m) with scalar values, X (m, f) -> (n, f): g-SpMM on the reversed
    relation (rows aggregate over their columns). The reversed relation
    carries no plan, so this is the plain path."""
    if A.val.dim() != 1:
        raise DGLError("spmm requires scalar nnz values; use bspmm")
    return gspmm(A._rel.reverse(), "mul", "sum", X, A.val)


def bspmm(A: SparseMatrix, X):
    """Batched spmm for vector values (reference ``matmul.py:50``):
    A (n, m, h), X (m, f, h) -> (n, f, h)."""
    if A.val.dim() != 2:
        raise DGLError("bspmm requires (nnz, h) values")
    return gspmm(A._rel.reverse(), "mul", "sum", X, A.val[:, None, :])


def spspmm(A: SparseMatrix, B: SparseMatrix) -> SparseMatrix:
    """Sparse @ Sparse -> Sparse (reference ``matmul.py:88``, C++ CSRMM),
    with scipy on the host, as the reference computes it: entries in
    scipy's CSR order, values not differentiated."""
    import scipy.sparse as sp

    if A.val.dim() != 1 or B.val.dim() != 1:
        raise DGLError("spspmm requires scalar values")
    n, k = A.shape
    k2, m = B.shape
    if k != k2:
        raise DGLError(f"shape mismatch {A.shape} @ {B.shape}")

    def host(M, shape):
        r, c = M._rel.host_arrays("src", "dst")
        return sp.csr_matrix((M.val.detach().cpu().numpy(), (r, c)),
                             shape=shape)

    c = (host(A, (n, k)) @ host(B, (k, m))).tocoo()
    dtype = A.val.detach().cpu().numpy().dtype
    return from_coo(c.row.astype(np.int64), c.col.astype(np.int64),
                    c.data.astype(dtype), (n, m), device=A.val.device)


def matmul(A, B):
    """Dispatch like the reference ``matmul.py`` ``matmul``."""
    if isinstance(A, SparseMatrix) and isinstance(B, SparseMatrix):
        return spspmm(A, B)
    if isinstance(A, SparseMatrix):
        B = _tensor(B, A.val.device)
        if A.val.dim() == 2 and B.dim() == 3:
            return bspmm(A, B)
        return spmm(A, B)
    raise DGLError("matmul requires a SparseMatrix left operand")
