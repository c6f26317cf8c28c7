"""GINE layer (counterpart of ``dgl_tpu/nn/conv/gineconv.py``; reference
``python/dgl/nn/pytorch/conv/gineconv.py``): GIN with edge features, the
message ``relu(h_u + e)`` summed by ``update_all(copy_e, sum)``."""
from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from ... import function as fn
from .graphconv import expand_as_pair

__all__ = ["GINEConv"]


class GINEConv(nn.Module):
    """(reference ``gineconv.py:10``). ``apply_func`` as ``GINConv``'s;
    ``eps`` a (1,) parameter with ``learn_eps``.
    ``forward(graph, feat, edge_feat)``."""

    def __init__(self, apply_func: Optional[Callable] = None,
                 init_eps: float = 0.0, learn_eps: bool = False, *,
                 device="cuda"):
        super().__init__()
        self.apply_func = apply_func
        self.eps = (nn.Parameter(torch.full((1,), float(init_eps)))
                    if learn_eps else init_eps)
        self.to(device)

    def forward(self, graph, feat, edge_feat):
        with graph.local_scope() as g:
            feat_src, feat_dst = expand_as_pair(feat, g)
            g.srcdata["hn"] = feat_src
            g.edata["he"] = edge_feat
            g.apply_edges(fn.u_add_e("hn", "he", "m"))
            g.edata["m"] = torch.relu(g.edata["m"])
            g.update_all(fn.copy_e("m", "x"), fn.sum("x", "neigh"))
            rst = (1 + self.eps) * feat_dst + g.dstdata["neigh"]
            if self.apply_func is not None:
                rst = self.apply_func(rst)
            return rst
