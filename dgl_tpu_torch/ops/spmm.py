"""Generalized SpMM (g-SpMM): fused message + reduce over the graph.

Counterpart of ``dgl_tpu/ops/spmm.py``. :func:`gspmm` keeps the reference's
dispatch order: uniform-stride blocks, bitmap plan, dense-hub plan, shell
plan, then the plain path. Ported: the uniform-stride branch (all ops and
reducers), the bitmap branch (``copy_u`` with sum/mean on 2-D features),
the dense-hub branch (``copy_u`` with sum/mean), the shell branch (every op
with sum/mean through ``shell_gspmm_sum`` and its kernel, max/min through
``shell_gspmm_cmp``) and the plain path with all four reducers.

The uniform-stride branch serves fixed-shape MFG blocks, where edge
``d * f + j`` belongs to destination ``d`` or to the padding sink: it
gathers the messages, masks the sink's, and reduces a ``(num_dst, f)``
reshape (no scatter), as the reference does.

The plain path gathers the messages in CSC (dst-sorted) order and reduces
them over the real edges: sums with ``index_add``, max and min with
``scatter_reduce`` (zero-in-degree rows give 0, reference
``heterograph.py:5117-5123``). PyTorch's autograd differentiates both. A
tied maximum or minimum splits its gradient evenly among the tied
messages, on both sides (``scatter_reduce``'s rule; JAX's scatter-extremal
JVP averages them).
"""
from __future__ import annotations

import sys

import torch

from ..base import DGLError
from ..graph import Graph, Relation

__all__ = ["gspmm"]  # extended by _register below


def _reduce_grad(grad, shape):
    """Sum a gradient over the dims its input was broadcast along
    (reference ``backend/pytorch/sparse.py:43``)."""
    grad_shape = tuple(grad.shape[1:])
    in_shape = tuple(shape[1:])
    if grad_shape == in_shape:
        return grad
    num_to_squeeze = len(grad_shape) - len(in_shape)
    in_shape_pad = (1,) * num_to_squeeze + in_shape
    dims = tuple(i + 1 for i, (g, s) in enumerate(zip(grad_shape,
                                                       in_shape_pad))
                 if s == 1 and g > 1)
    if dims:
        grad = grad.sum(dim=dims, keepdim=True)
    if num_to_squeeze:
        grad = grad.reshape(grad.shape[:1] + in_shape)
    return grad


def _expand(x, ndim):
    """Right-pad feature dims so a 1-D tensor broadcasts like DGL ops do."""
    while x.dim() < ndim:
        x = x.unsqueeze(-1)
    return x


def _binary(op, lhs, rhs):
    if op == "add":
        return lhs + rhs
    if op == "sub":
        return lhs - rhs
    if op == "mul":
        return lhs * rhs
    if op == "div":
        return lhs / rhs
    if op == "copy_lhs":
        return lhs
    if op == "copy_rhs":
        return rhs
    raise DGLError(f"Unknown spmm binary op {op!r}")


def _messages_csc(op, rel: Relation, u, e):
    """Per-edge messages of the real edges in CSC (dst-sorted) order:
    padded edges sort to the end of the CSC arrays and are left out."""
    E = rel.num_edges
    ul = u.index_select(0, rel.csc_indices[:E]) if op != "copy_rhs" else None
    el = e.index_select(0, rel.csc_eids[:E]) if op != "copy_lhs" else None
    if ul is not None and el is not None:
        nd = max(ul.dim(), el.dim())
        ul, el = _expand(ul, nd), _expand(el, nd)
    return _binary(op, ul, el)


def _gspmm_sum(op, rel: Relation, u, e):
    """Sorted segment sum over the real edges."""
    m = _messages_csc(op, rel, u, e)
    out = m.new_zeros((rel.num_dst,) + tuple(m.shape[1:]))
    return out.index_add(0, rel.csc_dst[:rel.num_edges], m)


def _gspmm_cmp(op, reduce_op, rel: Relation, u, e):
    """Max or min over each destination's messages (reference
    ``spmm.py:202-210``); a row without in-edges keeps the initial 0."""
    m = _messages_csc(op, rel, u, e)
    idx = rel.csc_dst[:rel.num_edges].to(torch.int64)
    idx = idx.reshape((-1,) + (1,) * (m.dim() - 1)).expand_as(m)
    out = m.new_zeros((rel.num_dst,) + tuple(m.shape[1:]))
    return out.scatter_reduce(0, idx, m,
                              "amax" if reduce_op == "max" else "amin",
                              include_self=False)


def _stripe_valid(rel: Relation):
    """On a uniform-stride block, whether edge slot ``d * f + j`` (the
    first ``num_dst * f`` edges) is an edge of destination ``d``, not of
    the padding sink."""
    f, B = rel.uniform_stride, rel.num_dst
    stripe = torch.arange(B * f, device=rel.dst.device,
                          dtype=rel.dst.dtype) // f
    return rel.dst[:B * f] == stripe


def _gspmm_uniform(op, reduce_op, rel: Relation, u, e):
    """Masked reshape-and-reduce over a uniform-stride block (reference
    ``dgl_tpu/ops/spmm.py:164-192``): a slot counts where its edge's
    destination is its stripe's; max/min give 0 on a row with no such
    slot."""
    f, B = rel.uniform_stride, rel.num_dst
    E = B * f
    valid = _stripe_valid(rel)
    ul = u.index_select(0, rel.src[:E]) if op != "copy_rhs" else None
    el = e[:E] if op != "copy_lhs" else None
    if ul is not None and el is not None:
        nd = max(ul.dim(), el.dim())
        ul, el = _expand(ul, nd), _expand(el, nd)
    m = _binary(op, ul, el)
    v = valid.reshape((E,) + (1,) * (m.dim() - 1))
    shape = (B, f) + tuple(m.shape[1:])
    if reduce_op in ("sum", "mean"):
        out = torch.where(v, m, 0).reshape(shape).sum(1)
        return _mean(rel, out) if reduce_op == "mean" else out
    fill = -torch.inf if reduce_op == "max" else torch.inf
    red = torch.amax if reduce_op == "max" else torch.amin
    out = red(torch.where(v, m, fill).reshape(shape), dim=1)
    has = _expand(valid.reshape(B, f).any(1), out.dim())
    return torch.where(has, out, 0)


def _mean(rel: Relation, out):
    deg = torch.clamp(rel.in_degrees(), min=1).to(out.dtype)
    return out / _expand(deg, out.dim())


def gspmm(g, op, reduce_op, lhs_data, rhs_data, etype=None):
    """Fused message+reduce (reference ``python/dgl/ops/spmm.py:39``).

    ``op`` in {add, sub, mul, div, copy_lhs, copy_rhs}; ``reduce_op`` in
    {sum, mean, max, min}. ``lhs_data`` are source node features,
    ``rhs_data`` edge features. Returns destination-node features.
    """
    rel = g._relation(etype) if isinstance(g, Graph) else g
    u, e = lhs_data, rhs_data
    if op not in ("copy_lhs", "copy_rhs"):
        if u is None or e is None:
            raise DGLError(f"Binary op {op} needs both operands")
        nd = max(u.dim(), e.dim())
        u, e = _expand(u, nd), _expand(e, nd)
    if reduce_op not in ("sum", "mean", "max", "min"):
        raise DGLError(f"Unknown reduce op {reduce_op!r}")

    # fixed-shape MFG blocks: masked reshape+reduce, no scatter; a relation
    # with fewer edges than num_dst * stride takes the branches below
    if (rel.uniform_stride > 0
            and rel.num_dst * rel.uniform_stride <= rel.num_edges_padded):
        return _gspmm_uniform(op, reduce_op, rel, u, e)
    # packed-bitmap dense path (ops/bitmap_spmm.py): the adjacency streams
    # as bits through kernel B2, the high-degree (Reddit-class) path
    if (rel.bitmap_plan is not None and op == "copy_lhs"
            and reduce_op in ("sum", "mean") and u is not None
            and u.dim() == 2):
        from .bitmap_spmm import bitmap_copy_u_sum

        out = bitmap_copy_u_sum(rel.bitmap_plan, u)
        return _mean(rel, out) if reduce_op == "mean" else out

    # dense-hub fast path (ops/hub_spmm.py): one matmul for the hub edges,
    # the shell prefix-sum kernel for the cold tail
    if (rel.hub_plan is not None and op == "copy_lhs"
            and reduce_op in ("sum", "mean")):
        from .hub_spmm import hub_copy_u_sum

        out = hub_copy_u_sum(rel.hub_plan, u)
        return _mean(rel, out) if reduce_op == "mean" else out

    # full-edge shell path (ops/shell_spmm.py): every op with sum/mean
    # through the weighted shell kernel, max/min over the shells
    if rel.shell_plan is not None:
        if reduce_op in ("sum", "mean"):
            from .shell_spmm import shell_gspmm_sum

            out = shell_gspmm_sum(op, rel.shell_plan, u, e)
            return _mean(rel, out) if reduce_op == "mean" else out
        from .shell_spmm import shell_gspmm_cmp

        return shell_gspmm_cmp(op, reduce_op, rel.shell_plan, u, e,
                               rel.in_degrees())
    if reduce_op in ("sum", "mean"):
        out = _gspmm_sum(op, rel, u, e)
        return _mean(rel, out) if reduce_op == "mean" else out
    return _gspmm_cmp(op, reduce_op, rel, u, e)


def _gen_spmm_func(binary_op, reduce_op):
    def func(g, x, y, etype=None):
        return gspmm(g, binary_op, reduce_op, x, y, etype=etype)

    func.__name__ = f"u_{binary_op}_e_{reduce_op}"
    func.__doc__ = f"gspmm with message u {binary_op} e and {reduce_op} reducer."
    return func


def _gen_copy_spmm_func(target, reduce_op):
    def func(g, x, etype=None):
        if target == "u":
            return gspmm(g, "copy_lhs", reduce_op, x, None, etype=etype)
        return gspmm(g, "copy_rhs", reduce_op, None, x, etype=etype)

    func.__name__ = f"copy_{target}_{reduce_op}"
    func.__doc__ = f"gspmm copy_{target} with {reduce_op} reducer."
    return func


def _register():
    mod = sys.modules[__name__]
    for reduce_op in ("sum", "max", "min", "mean"):
        for binary_op in ("add", "sub", "mul", "div"):
            func = _gen_spmm_func(binary_op, reduce_op)
            setattr(mod, func.__name__, func)
            __all__.append(func.__name__)
        for target in ("u", "e"):
            func = _gen_copy_spmm_func(target, reduce_op)
            setattr(mod, func.__name__, func)
            __all__.append(func.__name__)


_register()
