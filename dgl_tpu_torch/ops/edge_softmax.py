"""Edge softmax: softmax over the incoming edges of each destination node
(counterpart of ``dgl_tpu/ops/edge_softmax.py``; reference
``python/dgl/ops/edge_softmax.py:12``).

Ported: the plain branch, a numerically stable softmax whose reductions
(g-SpMM's max and sum over ``copy_e``) run over the sorted (CSC) view and
whose result is re-expressed in eid order with gathers; padded edges get
0. ``norm_by="src"`` normalises over out-edges through the reversed
relation. The autograd function saves only the output, as the reference's
``EdgeSoftmax.backward``
(``python/dgl/backend/pytorch/sparse.py:685``):

    grad_e = out * grad_out - out * sum_per_dst(out * grad_out)[dst]

On a uniform-stride block (``norm_by="dst"``) the softmax runs over each
destination's stripe of ``f`` slots, masked to the slots whose edge is the
destination's (reference ``dgl_tpu/ops/edge_softmax.py:28-50,82-88``), and
its backward is ``sds - out * sum_stripe(sds)`` with ``sds = out * dz``.

Over a shell plan (``with_spmm_plans(weighted=True)``) the max and the
exp-sum accumulate over the plan's rank-space prefixes
(``shell_spmm.shell_edge_softmax``; the reverse shells for
``norm_by="src"``), and the backward's per-node sum is
``shell_spmm.shell_edge_acc`` read back through each edge's rank position
(reference ``dgl_tpu/ops/edge_softmax.py:53-56,89-110``); padded edges get
0, as on the plain branch.
"""
from __future__ import annotations

import torch

from ..graph import Graph, Relation
from .sddmm import _gather_target, _mask_pad
from .spmm import _expand, _gspmm_cmp, _gspmm_sum, _stripe_valid

__all__ = ["edge_softmax"]


def _dst_max(rel: Relation, logits):
    """Each destination's largest logit over its real in-edges; 0 for a
    row without in-edges or whose maximum is not finite (the reference's
    shift)."""
    smax = _gspmm_cmp("copy_rhs", "max", rel, None, logits)
    return torch.where(torch.isfinite(smax), smax, 0.0)


def _uniform_reshape(rel: Relation, x):
    """The ``(B, f, *feat)`` stripes of per-edge values and their validity
    mask on a uniform-stride block; every edge must lie in a stripe
    (``E == num_dst * stride``), as the reference requires."""
    f, B = rel.uniform_stride, rel.num_dst
    valid = _stripe_valid(rel).reshape((B, f) + (1,) * (x.dim() - 1))
    return x[:B * f].reshape((B, f) + tuple(x.shape[1:])), valid


def _check_branch(norm_by: str):
    if norm_by not in ("dst", "src"):
        raise ValueError(f"norm_by must be 'dst' or 'src', got {norm_by!r}")


class _EdgeSoftmax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, rel, norm_by, logits):
        ctx.uniform = rel.uniform_stride > 0 and norm_by == "dst"
        if ctx.uniform:
            z, valid = _uniform_reshape(rel, logits)
            m = torch.where(valid, z, -torch.inf).amax(1, keepdim=True)
            m = torch.where(torch.isfinite(m), m, 0.0)
            ez = torch.where(valid, torch.exp(z - m), 0.0)
            s = torch.clamp(ez.sum(1, keepdim=True), min=1e-38)
            out = (ez / s).reshape(logits.shape)
            ctx.save_for_backward(out)
            ctx.stripes = z.shape[:2]
            return out
        ctx.shell = None
        if rel.shell_plan is not None:
            from .shell_spmm import _softmax_side, shell_edge_softmax

            out = _mask_pad(rel, shell_edge_softmax(rel.shell_plan, logits,
                                                    norm_by))
            ctx.rel, ctx.shell = rel, _softmax_side(rel.shell_plan, norm_by)
            ctx.save_for_backward(out)
            return out
        if norm_by == "src":
            rel = rel.reverse()
        z = torch.exp(logits - _gather_target(rel, "v", _dst_max(rel,
                                                                  logits)))
        # the real edges' exponentials summed per destination
        ssum = _gspmm_sum("copy_rhs", rel, None, z)
        out = z / _gather_target(rel, "v", torch.clamp(ssum, min=1e-38))
        # padded edges get 0 (the reference's clamped gathers leave
        # meaningless values, often inf, there) and so no gradient
        out = _mask_pad(rel, out)
        ctx.rel = rel
        ctx.save_for_backward(out)
        return out

    @staticmethod
    def backward(ctx, dz):
        (out,) = ctx.saved_tensors
        sds = out * dz
        if ctx.uniform:
            shape = ctx.stripes + tuple(out.shape[1:])
            sds_r, out_r = sds.reshape(shape), out.reshape(shape)
            grad = sds_r - out_r * sds_r.sum(1, keepdim=True)
            return None, None, grad.reshape(out.shape)
        rel = ctx.rel
        if ctx.shell is not None:
            from .shell_spmm import shell_edge_acc

            shells, res, n_out, rank_eid = ctx.shell
            accum = shell_edge_acc(shells, n_out, sds, kind="sum",
                                   residual=res).index_select(0, rank_eid)
            return None, None, sds - out * _expand(accum, sds.dim())
        accum = _gspmm_sum("copy_rhs", rel, None, sds)
        return None, None, sds - out * _gather_target(rel, "v", accum)


def edge_softmax(graph, logits, eids=None, norm_by="dst", etype=None):
    """Edge softmax (reference ``python/dgl/ops/edge_softmax.py:12``).

    ``logits``: (E, *) edge logits in eid order. Returns normalised scores
    of the same shape. ``norm_by="dst"`` normalises over each node's
    incoming edges (the GAT convention), ``"src"`` over its outgoing
    edges. With ``eids``, the softmax runs over that subset of edges only:
    the others take part as ``-inf`` logits and receive 0."""
    rel = graph._relation(etype) if isinstance(graph, Graph) else graph
    _check_branch(norm_by)
    if eids is None:
        return _EdgeSoftmax.apply(rel, norm_by, logits)
    mask = torch.zeros(rel.num_edges_padded, dtype=torch.bool,
                       device=logits.device)
    mask[torch.as_tensor(eids, device=logits.device).to(torch.int64)] = True
    mask = mask.reshape((-1,) + (1,) * (logits.dim() - 1))
    out = _EdgeSoftmax.apply(rel, norm_by,
                             torch.where(mask, logits, -torch.inf))
    return torch.where(mask, out, 0.0)
