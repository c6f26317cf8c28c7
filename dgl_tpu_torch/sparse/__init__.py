"""The ``dgl.sparse``-style SparseMatrix API (counterpart of
``dgl_tpu/sparse/``; reference ``python/dgl/sparse/``).

A ``SparseMatrix`` wraps COO/CSR/CSC index tensors and a value tensor
(scalar or vector nnz values), with the reference's ops: spmm/sddmm through
the port's g-SpMM and g-SDDMM, spspmm and pattern merges on the host,
softmax, reductions and elementwise ops on the values.

``from_bcoo``/``to_bcoo`` of the JAX package take and give a JAX ``BCOO``
and have no counterpart here; ``from_torch_sparse`` and
``to_torch_sparse_coo``/``_csr``/``_csc`` are the port's interchange.
"""
from .sparse_matrix import (
    SparseMatrix,
    spmatrix,
    from_coo,
    from_csr,
    from_csc,
    val_like,
    diag,
    identity,
)
from .matmul import spmm, bspmm, spspmm, matmul
from .sddmm import sddmm, bsddmm
from .softmax_mod import softmax
from .reduction import reduce as sp_reduce
from .reduction import reduce, sum, smax, smin, smean, sprod  # noqa: A004
from .unary import neg
from .elementwise_op import (
    add, sub, mul, div, power, inv,
    sp_add, sp_sub, sp_mul, sp_div, sp_power,
    spsp_add, spsp_mul, spsp_div,
)
from .convert import (
    from_scipy, to_scipy,
    from_torch_sparse, to_torch_sparse_coo, to_torch_sparse_csr,
    to_torch_sparse_csc,
)
from .broadcast import sp_broadcast_v, sp_add_v, sp_sub_v, sp_mul_v, sp_div_v
from .utils_mod import is_scalar

__all__ = [
    "reduce", "sum", "smax", "smin", "smean", "sprod",
    "sp_add", "sp_sub", "sp_mul", "sp_div", "sp_power",
    "spsp_add", "spsp_mul", "spsp_div",
    "sp_add_v", "sp_sub_v", "sp_mul_v", "sp_div_v",
    "from_torch_sparse", "to_torch_sparse_coo", "to_torch_sparse_csr",
    "to_torch_sparse_csc",
    "is_scalar",
    "SparseMatrix", "spmatrix", "from_coo", "from_csr", "from_csc",
    "val_like", "diag", "identity",
    "spmm", "bspmm", "spspmm", "matmul",
    "sddmm", "bsddmm",
    "softmax",
    "sp_reduce",
    "neg", "add", "sub", "mul", "div", "power", "inv",
    "from_scipy", "to_scipy",
    "sp_broadcast_v",
]
