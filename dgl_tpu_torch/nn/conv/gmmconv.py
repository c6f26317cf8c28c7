"""Gaussian mixture model convolution, MoNet (counterpart of
``dgl_tpu/nn/conv/gmmconv.py``; reference
``python/dgl/nn/pytorch/conv/gmmconv.py``): each edge's Gaussian weights
over its pseudo-coordinates gate K projections of the source row,
``update_all(u_mul_e, sum | mean | max)``, summed over the kernels."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ... import function as fn
from ...base import DGLError
from .._init import dense, flax_init
from .graphconv import expand_as_pair

__all__ = ["GMMConv"]


class GMMConv(nn.Module):
    """(reference ``gmmconv.py:13``). ``mu`` (K, dim) drawn as
    ``normal(0.1)``, ``inv_sigma`` (K, dim) ones, ``fc`` (K * out, no
    bias) and ``res_fc`` (with ``residual``) Xavier-normal, ``bias``
    (out,) zeros. ``forward(graph, feat, pseudo)``: ``pseudo``
    (E, dim)."""

    def __init__(self, in_feats: int, out_feats: int, dim: int,
                 n_kernels: int, aggregator_type: str = "sum",
                 residual: bool = False, bias: bool = True, *,
                 generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        if aggregator_type not in ("sum", "mean", "max"):
            raise DGLError(f"Invalid aggregator {aggregator_type!r}")
        self.out_feats, self.n_kernels = out_feats, n_kernels
        self.aggregator_type = aggregator_type
        self.mu = nn.Parameter(flax_init("normal", (n_kernels, dim),
                                         generator, std=0.1))
        self.inv_sigma = nn.Parameter(torch.ones(n_kernels, dim))
        self.fc = dense(in_feats, n_kernels * out_feats, False,
                        "xavier_normal", generator)
        self.res_fc = (dense(in_feats, out_feats, False, "xavier_normal",
                             generator) if residual else None)
        self.bias = nn.Parameter(torch.zeros(out_feats)) if bias else None
        self.to(device)

    def forward(self, graph, feat, pseudo):
        K = self.n_kernels
        with graph.local_scope() as g:
            feat_src, feat_dst = expand_as_pair(feat, g)
            g.srcdata["h"] = self.fc(feat_src).reshape(-1, K, self.out_feats)
            diff = pseudo[:, None, :] - self.mu[None, :, :]  # (E, K, dim)
            gw = torch.exp(-0.5 * ((diff * self.inv_sigma[None]) ** 2).sum(
                -1))  # (E, K)
            g.edata["w"] = gw[:, :, None]
            g.update_all(fn.u_mul_e("h", "w", "m"),
                         getattr(fn, self.aggregator_type)("m", "h"))
            rst = g.dstdata["h"].sum(1)  # over the kernels
            if self.res_fc is not None:
                rst = rst + self.res_fc(feat_dst)
            if self.bias is not None:
                rst = rst + self.bias
            return rst
