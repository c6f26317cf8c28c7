"""SchNet's continuous-filter convolution (counterpart of
``dgl_tpu/nn/conv/cfconv.py``; reference
``python/dgl/nn/pytorch/conv/cfconv.py``): a filter network over the edge
features gates the projected source rows,
``update_all(u_mul_e, sum)``."""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ... import function as fn
from .._init import dense

__all__ = ["CFConv", "ShiftedSoftplus"]


class ShiftedSoftplus(nn.Module):
    """``softplus(beta x) / beta - log(shift)`` (reference
    ``cfconv.py:14``)."""

    def __init__(self, beta: float = 1.0, shift: float = 2.0):
        super().__init__()
        self.beta, self.shift = beta, shift

    def forward(self, x):
        return (torch.nn.functional.softplus(self.beta * x) / self.beta
                - math.log(self.shift))


class CFConv(nn.Module):
    """(reference ``cfconv.py:42``). ``project_edge0``, ``project_edge1``,
    ``project_node`` (no bias) and ``project_out0``: ``nn.Linear`` drawn
    as flax's ``Dense`` default (LeCun-normal), zero biases.
    ``forward(g, node_feats, edge_feats)``."""

    def __init__(self, node_in_feats: int, edge_in_feats: int,
                 hidden_feats: int, out_feats: int, *,
                 generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        self.project_edge0 = dense(edge_in_feats, hidden_feats,
                                   generator=generator)
        self.project_edge1 = dense(hidden_feats, hidden_feats,
                                   generator=generator)
        self.project_node = dense(node_in_feats, hidden_feats, False,
                                  generator=generator)
        self.project_out0 = dense(hidden_feats, out_feats,
                                  generator=generator)
        self.ssp = ShiftedSoftplus()
        self.to(device)

    def forward(self, g, node_feats, edge_feats):
        ssp = self.ssp
        with g.local_scope() as graph:
            e = ssp(self.project_edge1(ssp(self.project_edge0(edge_feats))))
            graph.srcdata["hv"] = self.project_node(node_feats)
            graph.edata["he"] = e
            graph.update_all(fn.u_mul_e("hv", "he", "m"), fn.sum("m", "h"))
            return ssp(self.project_out0(graph.dstdata["h"]))
