"""AGNN layer (counterpart of ``dgl_tpu/nn/conv/agnnconv.py``; reference
``python/dgl/nn/pytorch/conv/agnnconv.py``): the attention is the edge
softmax of ``beta * cos(h_u, h_v)``, aggregated with
``update_all(u_mul_e, sum)``."""
from __future__ import annotations

import torch
from torch import nn

from ... import function as fn
from ...ops.edge_softmax import edge_softmax
from .graphconv import expand_as_pair

__all__ = ["AGNNConv"]


class AGNNConv(nn.Module):
    """(reference ``agnnconv.py:12``). ``beta`` is a (1,) parameter with
    ``learn_beta``, else a buffer. As the reference's, both sides' cosines
    read the source features' norms (a block's destination rows are the
    first source rows), and no zero in-degree check runs."""

    def __init__(self, init_beta: float = 1.0, learn_beta: bool = True,
                 allow_zero_in_degree: bool = False, *, device="cuda"):
        super().__init__()
        self.allow_zero_in_degree = allow_zero_in_degree
        beta = torch.tensor([init_beta], dtype=torch.float32)
        if learn_beta:
            self.beta = nn.Parameter(beta)
        else:
            self.register_buffer("beta", beta)
        self.to(device)

    def forward(self, graph, feat):
        with graph.local_scope() as g:
            feat_src, _ = expand_as_pair(feat, g)
            g.srcdata["h"] = feat_src
            norm_h = feat_src / (torch.linalg.vector_norm(
                feat_src, dim=-1, keepdim=True) + 1e-12)
            g.srcdata["norm_h"] = norm_h
            g.dstdata["norm_h"] = (norm_h[:g.num_dst_nodes()] if g.is_block
                                   else norm_h)
            g.apply_edges(fn.u_dot_v("norm_h", "norm_h", "cos"))
            g.edata["p"] = edge_softmax(g, self.beta * g.edata["cos"])
            g.update_all(fn.u_mul_e("h", "p", "m"), fn.sum("m", "h"))
            return g.dstdata["h"]
