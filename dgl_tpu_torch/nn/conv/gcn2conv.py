"""GCNII layer (counterpart of ``dgl_tpu/nn/conv/gcn2conv.py``; reference
``python/dgl/nn/pytorch/conv/gcn2conv.py``): initial residual and identity
mapping, ``rst = (1 - beta) s + beta s W`` with
``s = (1 - alpha) P h + alpha h0`` and ``beta = log(lambda / layer + 1)``.
``P h`` is ``update_all(copy_u, sum)`` between the degree norms (kernel B1
on a hub plan), or with edge weights ``update_all(u_mul_e, sum)`` (the
weighted shell kernel on a shell plan)."""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch
from torch import nn

from ... import function as fn
from .._init import flax_init
from .graphconv import check_zero_in_degree

__all__ = ["GCN2Conv"]


class GCN2Conv(nn.Module):
    """(reference ``gcn2conv.py:14``). ``weight1`` (and ``weight2``
    without ``project_initial_features``) (D, D), drawn as the reference's
    ``normal(1.0)``; ``bias_param`` (D,) zeros.
    ``forward(graph, feat, feat_0, edge_weight=None)``."""

    def __init__(self, in_feats: int, layer: int = 1, alpha: float = 0.1,
                 lambda_: float = 1.0, project_initial_features: bool = True,
                 allow_zero_in_degree: bool = False, bias: bool = True,
                 activation: Optional[Callable] = None, *,
                 generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        D = in_feats
        self.alpha = alpha
        self.beta = math.log(lambda_ / layer + 1)
        self.allow_zero_in_degree = allow_zero_in_degree
        self.activation = activation
        self.weight1 = nn.Parameter(flax_init("normal", (D, D), generator))
        self.weight2 = (None if project_initial_features else nn.Parameter(
            flax_init("normal", (D, D), generator)))
        self.bias_param = nn.Parameter(torch.zeros(D)) if bias else None
        self.to(device)

    def forward(self, graph, feat, feat_0, edge_weight=None):
        check_zero_in_degree(graph, self.allow_zero_in_degree)
        with graph.local_scope() as g:
            if edge_weight is None:
                norm = torch.rsqrt(torch.clamp(
                    g.in_degrees().to(feat.dtype), min=1))[:, None]
                out_norm = torch.rsqrt(torch.clamp(
                    g.out_degrees().to(feat.dtype), min=1))[:, None]
                g.srcdata["h"] = feat * out_norm
                g.update_all(fn.copy_u("h", "m"), fn.sum("m", "h"))
                h = g.dstdata["h"] * norm
            else:
                g.srcdata["h"] = feat
                g.edata["_w"] = edge_weight
                g.update_all(fn.u_mul_e("h", "_w", "m"), fn.sum("m", "h"))
                h = g.dstdata["h"]
            h = h * (1 - self.alpha)
            f0 = feat_0[:h.shape[0]] * self.alpha
            feat_sum = h + f0
            if self.weight2 is None:
                proj = feat_sum @ self.weight1
            else:
                proj = h @ self.weight1 + f0 @ self.weight2
            rst = (1 - self.beta) * feat_sum + self.beta * proj
            if self.bias_param is not None:
                rst = rst + self.bias_param
            if self.activation is not None:
                rst = self.activation(rst)
            return rst
