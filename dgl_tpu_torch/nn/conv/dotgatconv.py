"""Dot-product graph attention (counterpart of
``dgl_tpu/nn/conv/dotgatconv.py``; reference
``python/dgl/nn/pytorch/conv/dotgatconv.py``):
``a = edge_softmax(<W h_u, W h_v> / sqrt(O))``, aggregated with
``update_all(u_mul_e, sum)``."""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ... import function as fn
from ...ops.edge_softmax import edge_softmax
from .._init import dense
from .graphconv import check_zero_in_degree, expand_as_pair

__all__ = ["DotGatConv"]


class DotGatConv(nn.Module):
    """(reference ``dotgatconv.py:11``). ``fc``: one ``nn.Linear`` without
    bias for both sides, Xavier-uniform."""

    def __init__(self, in_feats: int, out_feats: int, num_heads: int,
                 allow_zero_in_degree: bool = False, *,
                 generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        self.num_heads, self.out_feats = num_heads, out_feats
        self.allow_zero_in_degree = allow_zero_in_degree
        self.fc = dense(in_feats, num_heads * out_feats, False,
                        "xavier_uniform", generator)
        self.to(device)

    def forward(self, graph, feat, get_attention: bool = False):
        check_zero_in_degree(graph, self.allow_zero_in_degree)
        H, O = self.num_heads, self.out_feats
        with graph.local_scope() as g:
            feat_src, feat_dst = expand_as_pair(feat, g)
            g.srcdata["ft"] = self.fc(feat_src).reshape(-1, H, O)
            g.dstdata["ft"] = self.fc(feat_dst).reshape(-1, H, O)
            g.apply_edges(fn.u_dot_v("ft", "ft", "a"))
            sa = edge_softmax(g, g.edata["a"] / math.sqrt(O))  # (E, H, 1)
            g.edata["sa"] = sa
            g.update_all(fn.u_mul_e("ft", "sa", "m"), fn.sum("m", "agg_u"))
            rst = g.dstdata["agg_u"]
            if get_attention:
                return rst, sa
            return rst
