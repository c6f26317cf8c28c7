"""SparseMatrix class (counterpart of ``dgl_tpu/sparse/sparse_matrix.py``;
reference ``python/dgl/sparse/sparse_matrix.py:8``).

A :class:`SparseMatrix` wraps a :class:`~dgl_tpu_torch.graph.Relation` (COO
+ CSR + CSC index tensors, rows as sources and columns as destinations) and
a value tensor of ``(nnz,)`` or ``(nnz, d)``. Pattern work (merging,
coalescing) runs on the host with numpy, in the reference's order; values
stay on the matrix's device and keep their autograd history.

A matrix from a padded graph's ``adj()`` holds the padded entries too:
their rows and columns are the virtual rows ``num_src``/``num_dst``, out
of range. The reference's scatters drop them and its gathers clamp them to
the last row (JAX's out-of-range rules); the port does both explicitly.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..base import DGLError
from ..graph import Relation, _asnumpy

__all__ = [
    "SparseMatrix", "spmatrix", "from_coo", "from_csr", "from_csc",
    "val_like", "diag", "identity",
]


def _device_of(device, *xs) -> torch.device:
    """``device`` if given, else the first tensor's among ``xs``, else the
    card."""
    if device is not None:
        return torch.device(device)
    for x in xs:
        if isinstance(x, torch.Tensor):
            return x.device
    return torch.device("cuda")


def _tensor(x, device) -> torch.Tensor:
    """``x`` as a tensor on ``device`` (a tensor keeps its history)."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.as_tensor(np.asarray(x), device=device)


def _operand(other, like: torch.Tensor):
    """A dense operand of an elementwise op: numbers stay numbers."""
    if isinstance(other, (np.ndarray, list, tuple)):
        return _tensor(other, like.device)
    return other


class SparseMatrix:
    """COO-backed sparse matrix with the CSR and CSC of its relation.

    ``val`` is (nnz,) or (nnz, d), as in the reference (vector values for
    multi-head attention matrices).
    """

    def __init__(self, rel: Relation, val):
        self._rel = rel
        self.val = val

    # -- basic properties ----------------------------------------------------

    @property
    def shape(self) -> Tuple[int, int]:
        return (self._rel.num_src, self._rel.num_dst)

    @property
    def nnz(self) -> int:
        return self._rel.num_edges

    @property
    def dtype(self):
        return self.val.dtype

    @property
    def row(self):
        return self._rel.src

    @property
    def col(self):
        return self._rel.dst

    def coo(self):
        return self.row, self.col

    def csr(self):
        r = self._rel
        return r.csr_indptr, r.csr_indices, r.csr_eids

    def csc(self):
        r = self._rel
        return r.csc_indptr, r.csc_indices, r.csc_eids

    def indices(self):
        return torch.stack([self.row, self.col])

    # -- conversion ----------------------------------------------------------

    def to_dense(self):
        n, m = self.shape
        E = self.nnz  # padded entries lie out of range: dropped
        v = self.val
        dense = v.new_zeros((n, m) + tuple(v.shape[1:]))
        return dense.index_put((self.row[:E].long(), self.col[:E].long()),
                               v[:E], accumulate=True)

    def t(self) -> "SparseMatrix":
        return SparseMatrix(self._rel.reverse(), self.val)

    @property
    def T(self):
        return self.t()

    def transpose(self):
        return self.t()

    # -- elementwise ---------------------------------------------------------

    def _ew(self, other, op):
        if isinstance(other, SparseMatrix):
            if self.shape != other.shape:
                raise DGLError("shape mismatch")
            # same sparsity fast path
            if self._rel is other._rel or (
                self.nnz == other.nnz
                and torch.equal(self.row, other.row.to(self.row.device))
                and torch.equal(self.col, other.col.to(self.col.device))
            ):
                return SparseMatrix(self._rel, op(self.val, other.val))
            if op in (_add, _sub):
                # merge sparsity patterns on the host
                return _merge(self, other, op)
            raise DGLError(
                "elementwise mul/div require identical sparsity patterns"
            )
        return SparseMatrix(self._rel, op(self.val, _operand(other,
                                                             self.val)))

    def __add__(self, other):
        return self._ew(other, _add)

    def __sub__(self, other):
        return self._ew(other, _sub)

    def __mul__(self, other):
        return self._ew(other, _mul)

    def __rmul__(self, other):
        return self._ew(other, _mul)

    def __truediv__(self, other):
        return self._ew(other, _div)

    def __pow__(self, p):
        return SparseMatrix(self._rel, self.val ** p)

    def __neg__(self):
        return SparseMatrix(self._rel, -self.val)

    def __matmul__(self, other):
        from .matmul import matmul

        return matmul(self, other)

    # -- reductions ----------------------------------------------------------

    def reduce(self, op: str = "sum", dim: Optional[int] = None):
        from .reduction import reduce as _reduce

        return _reduce(self, op, dim)

    def sum(self, dim: Optional[int] = None):
        return self.reduce("sum", dim)

    def smax(self, dim: Optional[int] = None):
        return self.reduce("smax", dim)

    def smin(self, dim: Optional[int] = None):
        return self.reduce("smin", dim)

    def smean(self, dim: Optional[int] = None):
        return self.reduce("smean", dim)

    def sprod(self, dim: Optional[int] = None):
        return self.reduce("sprod", dim)

    def softmax(self, dim: int = 1):
        from .softmax_mod import softmax as _softmax

        return _softmax(self, dim)

    def _pairs(self) -> np.ndarray:
        r, c = self._rel.host_arrays("src", "dst")
        return np.stack([r, c], 1)

    def coalesce(self) -> "SparseMatrix":
        """Merge duplicate (row, col) entries, in lexicographic (row, col)
        order (reference ``coalesce``)."""
        uniq, inv = np.unique(self._pairs(), axis=0, return_inverse=True)
        val = _segment_sum(self.val, inv, uniq.shape[0])
        return from_coo(uniq[:, 0], uniq[:, 1], val, self.shape,
                        device=self.val.device)

    def has_duplicate(self) -> bool:
        return len(np.unique(self._pairs(), axis=0)) < self.nnz

    def is_diag(self) -> bool:
        return torch.equal(self.row, self.col)

    def __repr__(self):
        return (
            f"SparseMatrix(indices={tuple(self.indices().shape)}, "
            f"values={tuple(self.val.shape)}, shape={self.shape}, "
            f"nnz={self.nnz})"
        )


def _add(a, b):
    return a + b


def _sub(a, b):
    return a - b


def _mul(a, b):
    return a * b


def _div(a, b):
    return a / b


def _segment_sum(val, seg: np.ndarray, n: int):
    """Sum the rows of ``val`` into ``n`` segments by the host ids ``seg``
    (every id in range)."""
    idx = torch.from_numpy(np.ascontiguousarray(seg.reshape(-1))).to(
        val.device)
    return val.new_zeros((n,) + tuple(val.shape[1:])).index_add(0, idx, val)


def _merge(a: SparseMatrix, b: SparseMatrix, op):
    """Union-of-patterns add/sub on the host (reference CSRSum), in
    lexicographic (row, col) order."""
    pairs = np.concatenate([a._pairs(), b._pairs()])
    sign = 1.0 if op is _add else -1.0
    vals = torch.cat([a.val, sign * b.val.to(a.val.device)])
    uniq, inv = np.unique(pairs, axis=0, return_inverse=True)
    val = _segment_sum(vals, inv, uniq.shape[0])
    return from_coo(uniq[:, 0], uniq[:, 1], val, a.shape,
                    device=a.val.device)


# -- constructors ------------------------------------------------------------


def from_coo(row, col, val=None, shape=None, *, device=None) -> SparseMatrix:
    """A matrix from COO indices (reference ``sparse_matrix.py``
    ``from_coo``). On ``device``, else on the device of the first tensor
    among ``row``, ``col`` and ``val``, else on the card. Without ``val``
    every value is 1 (f32)."""
    device = _device_of(device, row, col, val)
    row = _asnumpy(row)
    col = _asnumpy(col)
    if shape is None:
        shape = (int(row.max()) + 1 if row.size else 0,
                 int(col.max()) + 1 if col.size else 0)
    if val is None:
        val = torch.ones((row.shape[0],), dtype=torch.float32, device=device)
    rel = Relation.from_coo(row, col, shape[0], shape[1], device=device)
    return SparseMatrix(rel, _tensor(val, device))


spmatrix = from_coo


def from_csr(indptr, indices, val=None, shape=None, *,
             device=None) -> SparseMatrix:
    """A matrix from CSR (reference ``from_csr``); device as ``from_coo``."""
    device = _device_of(device, indptr, indices, val)
    indptr = _asnumpy(indptr)
    indices = _asnumpy(indices)
    n = indptr.shape[0] - 1
    m = shape[1] if shape is not None else (
        int(indices.max()) + 1 if indices.size else 0)
    row = np.repeat(np.arange(n), np.diff(indptr))
    return from_coo(row, indices, val, (n, m), device=device)


def from_csc(indptr, indices, val=None, shape=None, *,
             device=None) -> SparseMatrix:
    """A matrix from CSC (reference ``from_csc``); device as ``from_coo``."""
    device = _device_of(device, indptr, indices, val)
    indptr = _asnumpy(indptr)
    indices = _asnumpy(indices)
    m = indptr.shape[0] - 1
    n = shape[0] if shape is not None else (
        int(indices.max()) + 1 if indices.size else 0)
    col = np.repeat(np.arange(m), np.diff(indptr))
    return from_coo(indices, col, val, (n, m), device=device)


def val_like(mat: SparseMatrix, val) -> SparseMatrix:
    """Same sparsity, new values (reference ``val_like``)."""
    return SparseMatrix(mat._rel, _tensor(val, mat.val.device))


def diag(val, shape=None, *, device=None) -> SparseMatrix:
    """A diagonal matrix (reference ``diag``); device as ``from_coo``."""
    device = _device_of(device, val)
    val = _tensor(val, device)
    n = val.shape[0]
    shape = shape or (n, n)
    idx = np.arange(n)
    return from_coo(idx, idx, val, shape, device=device)


def identity(shape, d=None, dtype=torch.float32, *,
             device="cuda") -> SparseMatrix:
    """The identity of ``shape`` (reference ``identity``), (n,) or (n, d)
    ones."""
    n = min(shape)
    val = torch.ones((n,) if d is None else (n, d), dtype=dtype,
                     device=device)
    return diag(val, shape)
