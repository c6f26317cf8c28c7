"""Interop with scipy and torch sparse tensors (counterpart of
``dgl_tpu/sparse/convert.py``; reference
``python/dgl/sparse/sparse_matrix.py:1284-1443``).

The reference's ``from_bcoo``/``to_bcoo`` take and give a JAX ``BCOO``;
their counterparts here are ``from_torch_sparse`` and
``to_torch_sparse_coo``/``_csr``/``_csc``.
"""
from __future__ import annotations

import numpy as np
import torch

from .sparse_matrix import SparseMatrix, from_coo

__all__ = [
    "from_scipy", "to_scipy", "from_torch_sparse", "to_torch_sparse_coo",
    "to_torch_sparse_csr", "to_torch_sparse_csc",
]


def from_scipy(mat, *, device="cuda") -> SparseMatrix:
    """A matrix from a scipy sparse matrix, in its COO order."""
    coo = mat.tocoo()
    return from_coo(np.asarray(coo.row), np.asarray(coo.col),
                    np.asarray(coo.data), tuple(coo.shape), device=device)


def to_scipy(A: SparseMatrix):
    import scipy.sparse as sp

    r, c = A._rel.host_arrays("src", "dst")
    return sp.coo_matrix((A.val.detach().cpu().numpy(), (r, c)),
                         shape=A.shape)


def from_torch_sparse(t) -> SparseMatrix:
    """A matrix from a torch sparse COO, CSR or CSC tensor, coalesced, on
    the tensor's device (reference ``sparse_matrix.py:1284``)."""
    if t.layout == torch.sparse_coo:
        t = t.coalesce()
        idx = t.indices()
        return from_coo(idx[0], idx[1], t.values(), tuple(t.shape))
    if t.layout in (torch.sparse_csr, torch.sparse_csc):
        return from_torch_sparse(t.to_sparse_coo())
    raise ValueError(f"unsupported torch sparse layout {t.layout}")


def to_torch_sparse_coo(A: SparseMatrix):
    """Reference ``python/dgl/sparse/sparse_matrix.py:1342``: uncoalesced,
    in entry order, on the matrix's device."""
    idx = torch.stack([A.row, A.col]).long()
    return torch.sparse_coo_tensor(idx, A.val, size=A.shape)


def to_torch_sparse_csr(A: SparseMatrix):
    """Reference ``python/dgl/sparse/sparse_matrix.py:1373``."""
    return to_torch_sparse_coo(A).coalesce().to_sparse_csr()


def to_torch_sparse_csc(A: SparseMatrix):
    """Reference ``python/dgl/sparse/sparse_matrix.py:1411``."""
    return to_torch_sparse_coo(A).coalesce().to_sparse_csc()
