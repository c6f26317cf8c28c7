"""Graph attention layer (counterpart of ``dgl_tpu/nn/conv/gatconv.py``).

Reference: ``python/dgl/nn/pytorch/conv/gatconv.py``. The reference picks
one of four routes for the attention; two are ported:

- the bitmap-flash route (``ops/bitmap_gat.py``, kernels B3 to B5: B3
  walks the relation's CSC, B4 and B5 the plan's bitmap), taken
  when the graph carries a bitmap plan (``Graph.with_spmm_plans(bitmap=
  ...)``), there are no edge weights, no attention is returned and no
  attention dropout runs;
- the per-edge route, everywhere else: ``apply_edges(u_add_v)``, leaky
  ReLU, ``edge_softmax``, the edge weights, attention dropout in training
  mode, ``update_all(u_mul_e, sum)`` (reference ``gatconv.py:337-346``).

The other two raise with their ROADMAP items: dense masked attention, where
the reference attaches a dense-attention plan (the relation's
``dense_attn`` mark), and fused shell-space attention over a shell plan
(both ROADMAP queue A7).
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch
from torch import nn

from ... import function as fn
from ...ops.edge_softmax import edge_softmax
from .graphconv import check_zero_in_degree, expand_as_pair


def _xavier_uniform_flax(shape, generator):
    """flax's ``xavier_uniform`` for a (1, H, O) parameter: fan_in = H,
    fan_out = O (its fans read the last two axes)."""
    bound = math.sqrt(6.0 / (shape[-2] + shape[-1]))
    return (torch.rand(shape, generator=generator) * 2 - 1) * bound


class GATConv(nn.Module):
    """GAT layer (reference ``gatconv.py:17``).

    ``fc`` (and ``res_fc`` with ``residual``) are ``nn.Linear`` without
    bias; ``attn_l``, ``attn_r`` and ``bias`` have shape (1, H, O), as in
    the reference's flax module, so
    :func:`dgl_tpu_torch.params.from_flax_params` maps them. Parameters
    are drawn on the CPU from ``generator`` and the module is then moved to
    ``device``. Dropout runs in training mode only.
    """

    def __init__(self, in_feats: int, out_feats: int, num_heads: int,
                 feat_drop: float = 0.0, attn_drop: float = 0.0,
                 negative_slope: float = 0.2, residual: bool = False,
                 activation: Optional[Callable] = None,
                 allow_zero_in_degree: bool = False, bias: bool = True, *,
                 generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        H, O = num_heads, out_feats
        self.in_feats = in_feats
        self.out_feats = out_feats
        self.num_heads = num_heads
        self.attn_drop = attn_drop
        self.negative_slope = negative_slope
        self.activation = activation
        self.allow_zero_in_degree = allow_zero_in_degree
        self.feat_drop = nn.Dropout(feat_drop)
        self.fc = nn.Linear(in_feats, H * O, bias=False)
        with torch.no_grad():
            nn.init.xavier_uniform_(self.fc.weight, generator=generator)
        self.attn_l = nn.Parameter(_xavier_uniform_flax((1, H, O), generator))
        self.attn_r = nn.Parameter(_xavier_uniform_flax((1, H, O), generator))
        self.res_fc = None
        if residual:
            self.res_fc = nn.Linear(in_feats, H * O, bias=False)
            with torch.no_grad():
                nn.init.xavier_uniform_(self.res_fc.weight,
                                        generator=generator)
        self.bias = nn.Parameter(torch.zeros(1, H, O)) if bias else None
        self.to(device)

    def forward(self, graph, feat, edge_weight=None, get_attention=False):
        check_zero_in_degree(graph, self.allow_zero_in_degree)
        H, O = self.num_heads, self.out_feats
        with graph.local_scope() as g:
            feat_src, feat_dst = expand_as_pair(feat, g)
            # one projection serves both sides unless dropout draws a
            # separate mask for each, as the reference's does in training
            shared = feat_dst is feat_src and not (
                self.training and self.feat_drop.p > 0)
            feat_src = self.feat_drop(feat_src)
            feat_dst = feat_src if shared else self.feat_drop(feat_dst)
            h_src = self.fc(feat_src).reshape(-1, H, O)
            h_dst = (h_src if shared
                     else self.fc(feat_dst).reshape(-1, H, O))
            el = (h_src * self.attn_l).sum(-1)  # (N_src, H)
            er = (h_dst * self.attn_r).sum(-1)  # (N_dst, H)
            rel = g._relation(None)
            fused = edge_weight is None and not get_attention
            if rel.dense_attn and fused:
                raise NotImplementedError(
                    "GATConv over a dense-attention plan (ops/dense_attn.py, "
                    "the reference's small-graph route): ROADMAP queue A7; "
                    "build the graph with with_spmm_plans(dense_attn=False) "
                    "to take the bitmap route")
            if (rel.bitmap_plan is not None and fused
                    and (self.attn_drop == 0 or not self.training)):
                from ...ops.bitmap_gat import bitmap_gat

                rst = bitmap_gat(self.negative_slope, rel.bitmap_plan, el,
                                 er, h_src, rel)
                return self._finish(rst, feat_dst, H, O)
            if rel.shell_plan is not None and fused:
                raise NotImplementedError(
                    "GATConv over a shell plan (ops/fused_gat.py, fused "
                    "shell-space attention): ROADMAP queue A7")
            g.srcdata.update({"ft": h_src, "el": el.unsqueeze(-1)})
            g.dstdata.update({"er": er.unsqueeze(-1)})
            g.apply_edges(fn.u_add_v("el", "er", "e"))
            e = nn.functional.leaky_relu(g.edata["e"], self.negative_slope)
            a = edge_softmax(g, e)  # (E, H, 1)
            if edge_weight is not None:
                a = a * edge_weight.reshape(-1, 1, 1)
            if self.training and self.attn_drop > 0:
                a = nn.functional.dropout(a, self.attn_drop)
            g.edata["a"] = a
            g.update_all(fn.u_mul_e("ft", "a", "m"), fn.sum("m", "ft"))
            rst = self._finish(g.dstdata["ft"], feat_dst, H, O)
            return (rst, a) if get_attention else rst

    def _finish(self, rst, feat_dst, H, O):
        if self.res_fc is not None:
            rst = rst + self.res_fc(feat_dst).reshape(-1, H, O)
        if self.bias is not None:
            rst = rst + self.bias
        if self.activation is not None:
            rst = self.activation(rst)
        return rst
