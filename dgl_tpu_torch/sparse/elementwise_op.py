"""Module-level elementwise ops on SparseMatrix (counterpart of
``dgl_tpu/sparse/elementwise_op.py``; reference
``python/dgl/sparse/elementwise_op.py:11-167`` and ``unary_op.py:5,29``).

The operator forms (``A + B``, ``A * 2``) live on the class; these are the
functional aliases the reference also exports.
"""
from __future__ import annotations

import numpy as np
import torch

from ..base import DGLError
from .sparse_matrix import SparseMatrix, diag, from_coo
from .unary import neg

__all__ = [
    "add", "sub", "mul", "div", "power", "neg", "inv",
    "sp_add", "sp_sub", "sp_mul", "sp_div", "sp_power",
    "spsp_add", "spsp_mul", "spsp_div",
]


def add(A: SparseMatrix, B: SparseMatrix) -> SparseMatrix:
    return A + B


def sub(A: SparseMatrix, B: SparseMatrix) -> SparseMatrix:
    return A - B


def mul(A: SparseMatrix, B) -> SparseMatrix:
    return A * B


def div(A: SparseMatrix, B) -> SparseMatrix:
    return A / B


def power(A: SparseMatrix, scalar) -> SparseMatrix:
    return A ** scalar


# sparse-sparse and sparse-scalar aliases (reference
# ``python/dgl/sparse/elementwise_op_sp.py:10-40,183``)
sp_add, sp_sub, sp_mul, sp_div, sp_power = add, sub, mul, div, power
spsp_add = add


def spsp_mul(A: SparseMatrix, B: SparseMatrix) -> SparseMatrix:
    """Elementwise sparse x sparse product over the intersection of the
    patterns (reference ``elementwise_op_sp.py:17``), in increasing
    ``row * ncols + col`` order unless the patterns are identical."""
    if A.shape != B.shape:
        raise ValueError("shape mismatch")
    try:
        return A * B  # identical-pattern fast path
    except DGLError:
        pass
    ra, ca = A._rel.host_arrays("src", "dst")
    rb, cb = B._rel.host_arrays("src", "dst")
    key_a = ra.astype(np.int64) * A.shape[1] + ca
    key_b = rb.astype(np.int64) * B.shape[1] + cb
    common, ia, ib = np.intersect1d(key_a, key_b, return_indices=True)
    dev = A.val.device
    val = (A.val[torch.from_numpy(ia).to(dev)]
           * B.val.to(dev)[torch.from_numpy(ib).to(dev)])
    return from_coo(common // A.shape[1], common % A.shape[1], val, A.shape,
                    device=dev)


def spsp_div(A: SparseMatrix, B: SparseMatrix) -> SparseMatrix:
    """Elementwise sparse / sparse (reference ``elementwise_op_sp.py:24``:
    defined only when both operands share a sparsity pattern)."""
    return A / B


def inv(A: SparseMatrix) -> SparseMatrix:
    """Inverse of a diagonal matrix (reference ``unary_op.py:29``: only
    diagonal matrices are invertible in O(nnz))."""
    if A.shape[0] != A.shape[1] or not A.is_diag():
        raise ValueError("inv only supports square diagonal matrices")
    n = A.shape[0]
    if A.nnz != n:
        raise ValueError("diagonal contains explicit zeros; not invertible")
    # row order may be arbitrary; rebuild in index order
    order = torch.argsort(A.row, stable=True)
    return diag(1.0 / A.val[order], A.shape)
