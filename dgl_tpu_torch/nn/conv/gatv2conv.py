"""GATv2, dynamic graph attention (counterpart of
``dgl_tpu/nn/conv/gatv2conv.py``; reference
``python/dgl/nn/pytorch/conv/gatv2conv.py``): the attention reads
``leaky_relu(W_s h_u + W_d h_v)`` through ``attn``, and the aggregation is
``update_all(u_mul_e, sum)``, the weighted shell kernel on a graph with a
shell plan (``with_spmm_plans(weighted=True)``)."""
from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from ... import function as fn
from ...ops.edge_softmax import edge_softmax
from .._init import dense, flax_init
from .graphconv import check_zero_in_degree, expand_as_pair

__all__ = ["GATv2Conv"]


class GATv2Conv(nn.Module):
    """GATv2 layer (reference ``gatv2conv.py:15``).

    ``fc_src`` and ``fc_dst`` (one module with ``share_weights``) and
    ``res_fc`` are ``nn.Linear``; ``attn`` is (1, H, O), as the reference's
    flax parameters, Xavier-uniform. Dropout runs in training mode only;
    ``forward(graph, feat, get_attention=False)``."""

    def __init__(self, in_feats: int, out_feats: int, num_heads: int,
                 feat_drop: float = 0.0, attn_drop: float = 0.0,
                 negative_slope: float = 0.2, residual: bool = False,
                 activation: Optional[Callable] = None,
                 allow_zero_in_degree: bool = False, bias: bool = True,
                 share_weights: bool = False, *,
                 generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        H, O = num_heads, out_feats
        self.num_heads, self.out_feats = H, O
        self.negative_slope = negative_slope
        self.activation = activation
        self.allow_zero_in_degree = allow_zero_in_degree
        self.feat_drop = nn.Dropout(feat_drop)
        self.attn_drop = nn.Dropout(attn_drop)
        self.fc_src = dense(in_feats, H * O, bias, "xavier_uniform",
                            generator)
        self.fc_dst = None if share_weights else dense(
            in_feats, H * O, bias, "xavier_uniform", generator)
        self.attn = nn.Parameter(flax_init("xavier_uniform", (1, H, O),
                                           generator))
        self.res_fc = dense(in_feats, H * O, False, "xavier_uniform",
                            generator) if residual else None
        self.to(device)

    def forward(self, graph, feat, get_attention: bool = False):
        check_zero_in_degree(graph, self.allow_zero_in_degree)
        H, O = self.num_heads, self.out_feats
        with graph.local_scope() as g:
            feat_src, feat_dst = expand_as_pair(feat, g)
            feat_src = self.feat_drop(feat_src)
            feat_dst = self.feat_drop(feat_dst)
            fc_dst = self.fc_dst or self.fc_src
            h_src = self.fc_src(feat_src).reshape(-1, H, O)
            h_dst = fc_dst(feat_dst).reshape(-1, H, O)
            g.srcdata["el"] = h_src
            g.dstdata["er"] = h_dst
            g.apply_edges(fn.u_add_v("el", "er", "e"))
            e = torch.nn.functional.leaky_relu(g.edata["e"],
                                               self.negative_slope)
            e = (e * self.attn).sum(-1, keepdim=True)  # (E, H, 1)
            a = self.attn_drop(edge_softmax(g, e))
            g.edata["a"] = a
            g.srcdata["ft"] = h_src
            g.update_all(fn.u_mul_e("ft", "a", "m"), fn.sum("m", "ft"))
            rst = g.dstdata["ft"]
            if self.res_fc is not None:
                rst = rst + self.res_fc(feat_dst).reshape(-1, H, O)
            if self.activation is not None:
                rst = self.activation(rst)
            if get_attention:
                return rst, a
            return rst
