"""Heterogeneous Graph Transformer layer (counterpart of
``dgl_tpu/nn/conv/hgtconv.py``; reference
``python/dgl/nn/pytorch/conv/hgtconv.py``): typed Q/K/V projections,
per-relation attention and message matrices, a typed skip with a learned
gate. It runs on a homogeneous graph with node and edge type ids
(``to_homogeneous`` of a heterograph).

The reference gathers ``relation_att[etype]`` and ``relation_msg[etype]``
into (E, H, D, D) tensors, D * D * H floats an edge. The port builds no
such tensor: :func:`relation_rows` forms the same per-head products
``k[src] @ W[etype]`` either once per (source row, relation), before the
gather, when the graph has more edges than rows times relations, or per
edge through ``ops.gather_mm`` otherwise. Both sum the same D products
per output.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ... import ops
from .._init import flax_init
from ..linear import TypedLinear
from ..utils_nn import pad_edges

__all__ = ["HGTConv", "relation_rows"]


def relation_rows(x, w, src, etype):
    """``out[e, h] = x[src[e], h] @ w[etype[e], h]``: (E, H, D) rows of the
    (N, H, D) table ``x`` through the (R, H, D, F) relation matrices.

    With ``R * N <= E`` every row is multiplied by every relation's
    matrices first (an (R, N, H, F) table, fewer products than edges) and
    the edges gather from it; otherwise the edges' rows are gathered and
    multiplied one head at a time by ``ops.gather_mm``."""
    N, H, D = x.shape
    R, F = w.shape[0], w.shape[-1]
    E = src.shape[0]
    if R * N <= E:
        table = torch.einsum("nhd,rhdf->rnhf", x, w).reshape(R * N, H, F)
        return table.index_select(0, etype * N + src)
    rows = x.index_select(0, src).reshape(E * H, D)
    heads = torch.arange(H, device=x.device)
    idx = (etype.unsqueeze(1) * H + heads).reshape(E * H)
    return ops.gather_mm(rows, w.reshape(R * H, D, F), idx).reshape(E, H, F)


class HGTConv(nn.Module):
    """HGT layer (reference ``hgtconv.py:14``).

    Parameters as the reference's flax module names and shapes them:
    ``linear_q``, ``linear_k``, ``linear_v`` (``TypedLinear`` over node
    types), ``relation_pri`` (R, H) ones, ``relation_att`` and
    ``relation_msg`` (R, H, D, D) Xavier-uniform with flax's fans (the
    leading axes count in: fan-in and fan-out ``D * R * H``), ``skip``
    (num_ntypes,) ones, and with ``use_norm`` ``norm``, a ``LayerNorm``
    with flax's epsilon 1e-6. Dropout on the aggregate in training mode.

    ``forward(g, x, ntype, etype)``: ``x`` (N, in_size), ``ntype`` (N,)
    and ``etype`` (E,) type ids (``presorted`` is taken and not read, as
    by the reference). The arithmetic is the reference's: the
    logits are scaled by ``1/sqrt(D)`` and the softmax once more after
    ``edge_softmax``; the gated skip applies only when
    ``in_size == H * D``.
    """

    def __init__(self, in_size: int, head_size: int, num_heads: int,
                 num_ntypes: int, num_etypes: int, dropout: float = 0.2,
                 use_norm: bool = False, *,
                 generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        H, D = num_heads, head_size
        self.in_size, self.head_size, self.num_heads = in_size, D, H
        out = H * D
        for name in ("linear_q", "linear_k", "linear_v"):
            setattr(self, name, TypedLinear(in_size, out, num_ntypes,
                                            generator=generator,
                                            device="cpu"))
        self.relation_pri = nn.Parameter(torch.ones(num_etypes, H))
        self.relation_att = nn.Parameter(flax_init(
            "xavier_uniform", (num_etypes, H, D, D), generator))
        self.relation_msg = nn.Parameter(flax_init(
            "xavier_uniform", (num_etypes, H, D, D), generator))
        self.skip = nn.Parameter(torch.ones(num_ntypes))
        self.norm = nn.LayerNorm(out, eps=1e-6) if use_norm else None
        self.drop = nn.Dropout(dropout)
        self.to(device)

    def forward(self, g, x, ntype, etype, *, presorted: bool = False):
        H, D = self.num_heads, self.head_size
        sqrt_d = math.sqrt(D)
        ntype = ntype.to(torch.int64)
        q = self.linear_q(x, ntype).reshape(-1, H, D)
        k = self.linear_k(x, ntype).reshape(-1, H, D)
        v = self.linear_v(x, ntype).reshape(-1, H, D)
        rel = g._relation()
        E = rel.num_edges
        src = rel.src[:E].to(torch.int64)
        dst = rel.dst[:E].to(torch.int64)
        et = etype[:E].to(torch.int64)
        kt = relation_rows(k, self.relation_att, src, et)
        a = ((kt * q.index_select(0, dst)).sum(-1)
             * self.relation_pri.index_select(0, et) / sqrt_d)  # (E, H)
        m = relation_rows(v, self.relation_msg, src, et)  # (E, H, D)
        sa = ops.edge_softmax(rel, pad_edges(a.unsqueeze(-1), rel)) / sqrt_d
        t = ops.gspmm(rel, "copy_rhs", "sum", None,
                      pad_edges(m * sa[:E], rel))
        t = self.drop(t.reshape(-1, H * D))
        if self.in_size == H * D:
            alpha = torch.sigmoid(self.skip.index_select(0, ntype))[:, None]
            t = t * alpha + x * (1 - alpha)
        if self.norm is not None:
            t = self.norm(t)
        return t
