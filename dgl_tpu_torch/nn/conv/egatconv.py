"""EGAT, graph attention with edge features that updates node and edge
features (counterpart of ``dgl_tpu/nn/conv/egatconv.py``; reference
``python/dgl/nn/pytorch/conv/egatconv.py``)."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ... import function as fn
from ...ops.edge_softmax import edge_softmax
from .._init import dense, flax_init
from .graphconv import expand_as_pair

__all__ = ["EGATConv"]


class EGATConv(nn.Module):
    """(reference ``egatconv.py:12``). ``fc_node_src`` (H * On),
    ``fc_ni``, ``fc_fij``, ``fc_nj`` (H * Oe), all without bias, ``attn``
    (1, H, Oe) and ``bias`` (H * Oe,) as the reference's flax parameters,
    Xavier-normal (flax's truncated form), the bias zero.
    ``forward(graph, nfeats, efeats, get_attention=False)`` returns the
    (N, H, On) node and (E, H, Oe) edge features."""

    def __init__(self, in_node_feats: int, in_edge_feats: int,
                 out_node_feats: int, out_edge_feats: int, num_heads: int,
                 bias: bool = True, *,
                 generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        H = num_heads
        self.num_heads = H
        self.out_node_feats, self.out_edge_feats = (out_node_feats,
                                                    out_edge_feats)
        xn = "xavier_normal"
        self.fc_node_src = dense(in_node_feats, H * out_node_feats, False,
                                 xn, generator)
        self.fc_ni = dense(in_node_feats, H * out_edge_feats, False, xn,
                           generator)
        self.fc_fij = dense(in_edge_feats, H * out_edge_feats, False, xn,
                            generator)
        self.fc_nj = dense(in_node_feats, H * out_edge_feats, False, xn,
                           generator)
        self.attn = nn.Parameter(flax_init(xn, (1, H, out_edge_feats),
                                           generator))
        self.bias = (nn.Parameter(torch.zeros(H * out_edge_feats)) if bias
                     else None)
        self.to(device)

    def forward(self, graph, nfeats, efeats, get_attention: bool = False):
        H = self.num_heads
        with graph.local_scope() as g:
            f_src, f_dst = expand_as_pair(nfeats, g)
            g.srcdata["f_ni"] = self.fc_ni(f_src)
            g.dstdata["f_nj"] = self.fc_nj(f_dst)
            g.apply_edges(fn.u_add_v("f_ni", "f_nj", "f_tmp"))
            f_out = g.edata["f_tmp"] + self.fc_fij(efeats)
            if self.bias is not None:
                f_out = f_out + self.bias
            f_out = torch.nn.functional.leaky_relu(f_out).reshape(
                -1, H, self.out_edge_feats)
            e = (f_out * self.attn).sum(-1, keepdim=True)  # (E, H, 1)
            g.edata["a"] = edge_softmax(g, e)
            g.srcdata["h_out"] = self.fc_node_src(f_src).reshape(
                -1, H, self.out_node_feats)
            g.update_all(fn.u_mul_e("h_out", "a", "m"),
                         fn.sum("m", "h_out"))
            h_out = g.dstdata["h_out"].reshape(-1, H, self.out_node_feats)
            if get_attention:
                return h_out, f_out, g.edata["a"]
            return h_out, f_out
