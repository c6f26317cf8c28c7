"""GAT with edge features in the attention (counterpart of
``dgl_tpu/nn/conv/edgegatconv.py``; reference
``python/dgl/nn/pytorch/conv/edgegatconv.py``): the logit of edge (u, v)
is ``leaky_relu(el[u] + er[v] + ee[e])``, aggregated with
``update_all(u_mul_e, sum)``."""
from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from ... import function as fn
from ...ops.edge_softmax import edge_softmax
from .._init import dense, flax_init
from .graphconv import check_zero_in_degree, expand_as_pair

__all__ = ["EdgeGATConv"]


class EdgeGATConv(nn.Module):
    """(reference ``edgegatconv.py:12``). ``fc``, ``fc_edge`` and
    ``res_fc`` (with ``residual``, on by default) are ``nn.Linear``
    without bias; ``attn_l``, ``attn_r``, ``attn_e`` and ``bias`` are
    (1, H, O), as the reference's flax parameters, Xavier-normal (flax's
    truncated form), the bias zero. Dropout in training mode only;
    ``forward(graph, feat, edge_feat, get_attention=False)``."""

    def __init__(self, in_feats: int, edge_feats: int, out_feats: int,
                 num_heads: int, feat_drop: float = 0.0,
                 attn_drop: float = 0.0, negative_slope: float = 0.2,
                 residual: bool = True,
                 activation: Optional[Callable] = None,
                 allow_zero_in_degree: bool = False, bias: bool = True, *,
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
        xn = "xavier_normal"
        self.fc = dense(in_feats, H * O, False, xn, generator)
        self.fc_edge = dense(edge_feats, H * O, False, xn, generator)
        for name in ("attn_l", "attn_r", "attn_e"):
            setattr(self, name, nn.Parameter(flax_init(xn, (1, H, O),
                                                       generator)))
        self.res_fc = (dense(in_feats, H * O, False, xn, generator)
                       if residual else None)
        self.bias = nn.Parameter(torch.zeros(1, H, O)) if bias else None
        self.to(device)

    def forward(self, graph, feat, edge_feat, get_attention: bool = False):
        check_zero_in_degree(graph, self.allow_zero_in_degree)
        H, O = self.num_heads, self.out_feats
        with graph.local_scope() as g:
            feat_src, feat_dst = expand_as_pair(feat, g)
            feat_src = self.feat_drop(feat_src)
            feat_dst = self.feat_drop(feat_dst)
            h_src = self.fc(feat_src).reshape(-1, H, O)
            h_dst = self.fc(feat_dst).reshape(-1, H, O)
            f = self.fc_edge(edge_feat).reshape(-1, H, O)
            el = (h_src * self.attn_l).sum(-1, keepdim=True)
            er = (h_dst * self.attn_r).sum(-1, keepdim=True)
            ee = (f * self.attn_e).sum(-1, keepdim=True)
            g.srcdata.update({"ft": h_src, "el": el})
            g.dstdata.update({"er": er})
            g.apply_edges(fn.u_add_v("el", "er", "e"))
            e = torch.nn.functional.leaky_relu(g.edata["e"] + ee,
                                               self.negative_slope)
            a = self.attn_drop(edge_softmax(g, e))
            g.edata["a"] = a
            g.update_all(fn.u_mul_e("ft", "a", "m"), fn.sum("m", "ft"))
            rst = g.dstdata["ft"]
            if self.res_fc is not None:
                rst = rst + self.res_fc(feat_dst).reshape(-1, H, O)
            if self.bias is not None:
                rst = rst + self.bias
            if self.activation is not None:
                rst = self.activation(rst)
            if get_attention:
                return rst, a
            return rst
