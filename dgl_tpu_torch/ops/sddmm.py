"""Generalized SDDMM (g-SDDMM): per-edge binary ops between node and edge
data (counterpart of ``dgl_tpu/ops/sddmm.py``; reference
``python/dgl/ops/sddmm.py``).

Edges come out in eid (COO) order, gathered from the src/dst rows. The
backward is the reference's hand rule (``GSDDMM.backward``,
``python/dgl/backend/pytorch/sparse.py:443``; ``dgl_tpu``'s
``_gsddmm_bwd``): a node target's gradient is a sorted segment sum on the
CSR (``u``) or CSC (``v``) side, padded edges get no gradient, and
broadcast dims are summed back by ``_reduce_grad``.

Padded edges point at the sink rows ``num_src``/``num_dst``; their
gathers read the last real row, as the reference's clamped gathers do, and
their outputs are padding.
"""
from __future__ import annotations

import sys

import torch

from ..base import DGLError
from ..graph import Graph, Relation
from .spmm import _expand, _reduce_grad

__all__ = ["gsddmm"]  # extended by _register below


def _index(rel: Relation, target):
    """The eid-order row index of a node target, clamped into range where
    the relation has padded edges (the reference's gather semantics)."""
    if target == "u":
        idx, n = rel.src, rel.num_src
    elif target == "v":
        idx, n = rel.dst, rel.num_dst
    else:
        raise DGLError(f"Unknown sddmm target {target!r}")
    if rel.num_edges != rel.num_edges_padded:
        idx = torch.clamp(idx, max=max(n - 1, 0))
    return idx


def _gather_target(rel: Relation, target, data):
    """Bring node or edge data into eid order for ``target``."""
    if target == "e":
        return data
    return data.index_select(0, _index(rel, target))


def _scatter_target(rel: Relation, target, grad):
    """Transpose of :func:`_gather_target` over the real edges: a sorted
    segment sum back to the target's rows."""
    if target == "e":
        return grad
    E = rel.num_edges
    if target == "u":
        eids, seg, n = rel.csr_eids[:E], rel.csr_src[:E], rel.num_src
    else:
        eids, seg, n = rel.csc_eids[:E], rel.csc_dst[:E], rel.num_dst
    dm = grad.index_select(0, eids)
    return dm.new_zeros((n,) + tuple(dm.shape[1:])).index_add(0, seg, dm)


def _mask_pad(rel: Relation, x):
    if rel.num_edges == rel.num_edges_padded:
        return x
    return torch.where(_expand(rel.edge_mask(), x.dim()), x, 0)


def _sddmm_fwd(op, L, R):
    if L is not None and R is not None:
        nd = max(L.dim(), R.dim())
        L, R = _expand(L, nd), _expand(R, nd)
    if op == "add":
        return L + R
    if op == "sub":
        return L - R
    if op == "mul":
        return L * R
    if op == "div":
        return L / R
    if op == "dot":
        return (L * R).sum(dim=-1, keepdim=True)
    if op == "copy_lhs":
        return L
    if op == "copy_rhs":
        return R
    raise DGLError(f"Unknown sddmm op {op!r}")


class _GSDDMM(torch.autograd.Function):
    @staticmethod
    def forward(ctx, op, lhs_target, rhs_target, rel, lhs, rhs):
        ctx.op, ctx.targets, ctx.rel = op, (lhs_target, rhs_target), rel
        ctx.save_for_backward(lhs, rhs)
        L = None if lhs is None else _gather_target(rel, lhs_target, lhs)
        R = None if rhs is None else _gather_target(rel, rhs_target, rhs)
        return _sddmm_fwd(op, L, R)

    @staticmethod
    def backward(ctx, dz):
        op, (lt, rt), rel = ctx.op, ctx.targets, ctx.rel
        lhs, rhs = ctx.saved_tensors
        dz = _mask_pad(rel, dz)
        dlhs = drhs = None
        if lhs is not None and op != "copy_rhs" and ctx.needs_input_grad[4]:
            if op in ("copy_lhs", "add", "sub"):
                dL = dz
            elif op == "mul":
                dL = dz * _expand(_gather_target(rel, rt, rhs), dz.dim())
            elif op == "div":
                dL = dz / _expand(_gather_target(rel, rt, rhs), dz.dim())
            elif op == "dot":  # dz broadcasts over the reduced last dim
                dL = dz * _gather_target(rel, rt, rhs)
            else:
                raise DGLError(op)
            dlhs = _reduce_grad(_scatter_target(rel, lt, dL),
                                lhs.shape).to(lhs.dtype)
        if rhs is not None and op != "copy_lhs" and ctx.needs_input_grad[5]:
            Lg = None if lhs is None else _gather_target(rel, lt, lhs)
            if op in ("copy_rhs", "add"):
                dR = dz
            elif op == "sub":
                dR = -dz
            elif op == "mul":
                dR = dz * _expand(Lg, dz.dim())
            elif op == "div":
                Rg = _gather_target(rel, rt, rhs)
                nd = max(dz.dim(), Rg.dim())
                Rg = _expand(Rg, nd)
                dR = -dz * _expand(Lg, nd) / (Rg * Rg)
            elif op == "dot":
                dR = dz * Lg
            else:
                raise DGLError(op)
            drhs = _reduce_grad(_scatter_target(rel, rt, dR),
                                rhs.shape).to(rhs.dtype)
        return None, None, None, None, dlhs, drhs


def gsddmm(g, op, lhs_data, rhs_data, lhs_target="u", rhs_target="v",
           etype=None):
    """Per-edge op between node/edge data (reference ``ops/sddmm.py:13``).

    ``op`` in {add, sub, mul, div, dot, copy_lhs, copy_rhs}; targets in
    {u, v, e}. Returns (E_padded, ...) values in eid order."""
    rel = g._relation(etype) if isinstance(g, Graph) else g
    lhs, rhs = lhs_data, rhs_data
    if op not in ("copy_lhs", "copy_rhs") and lhs is not None and (
            rhs is not None):
        nd = max(lhs.dim(), rhs.dim())
        lhs, rhs = _expand(lhs, nd), _expand(rhs, nd)
    return _GSDDMM.apply(op, lhs_target, rhs_target, rel, lhs, rhs)


def _gen_sddmm_func(lhs_target, rhs_target, binary_op):
    def func(g, x, y, etype=None):
        return gsddmm(g, binary_op, x, y, lhs_target=lhs_target,
                      rhs_target=rhs_target, etype=etype)

    func.__name__ = f"{lhs_target}_{binary_op}_{rhs_target}"
    func.__doc__ = f"Edge value = {lhs_target} {binary_op} {rhs_target}."
    return func


def _gen_copy_func(target):
    def func(g, x, etype=None):
        return gsddmm(g, "copy_lhs", x, None, lhs_target=target, etype=etype)

    func.__name__ = f"copy_{target}"
    func.__doc__ = f"Edge value = the {target} node's feature."
    return func


def _register():
    mod = sys.modules[__name__]
    funcs = [_gen_sddmm_func(lt, rt, op)
             for lt in ("u", "v", "e") for rt in ("u", "v", "e") if lt != rt
             for op in ("add", "sub", "mul", "div", "dot")]
    funcs += [_gen_copy_func("u"), _gen_copy_func("v")]
    for func in funcs:
        setattr(mod, func.__name__, func)
        __all__.append(func.__name__)


_register()
