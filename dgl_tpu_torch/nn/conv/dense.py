"""Dense-adjacency conv layers (counterpart of ``dgl_tpu/nn/conv/dense.py``;
reference ``python/dgl/nn/pytorch/conv/densegraphconv.py``,
``densesageconv.py``, ``densechebconv.py``): they take an (N, N)
adjacency, rows the destinations, in place of a graph. The products are
``torch.matmul``, as the reference's are XLA dots."""
from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from .._init import dense, flax_init

__all__ = ["DenseGraphConv", "DenseSAGEConv", "DenseChebConv"]


class DenseGraphConv(nn.Module):
    """(reference ``densegraphconv.py:10``). ``weight`` (in, out)
    Xavier-uniform, ``bias`` zeros. ``norm`` ``"both"`` (sources by their
    out-degree, destinations by their in-degree, to the power -1/2),
    ``"right"`` (destinations by 1 / in-degree) or ``"none"``; degrees
    below 1 count as 1. ``forward(adj, feat)``."""

    def __init__(self, in_feats: int, out_feats: int, norm: str = "both",
                 bias: bool = True, activation: Optional[Callable] = None,
                 *, generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        self.in_feats, self.out_feats, self.norm = in_feats, out_feats, norm
        self.activation = activation
        self.weight = nn.Parameter(flax_init(
            "xavier_uniform", (in_feats, out_feats), generator))
        self.bias = nn.Parameter(torch.zeros(out_feats)) if bias else None
        self.to(device)

    def forward(self, adj, feat):
        adj = adj.to(feat.dtype)
        src_deg, in_deg = adj.sum(-2), adj.sum(-1)
        if self.norm == "both":
            feat = feat * torch.rsqrt(src_deg.clamp_min(1.0)).unsqueeze(-1)
        if self.in_feats > self.out_feats:
            rst = adj @ (feat @ self.weight)
        else:
            rst = (adj @ feat) @ self.weight
        if self.norm != "none":
            n = (torch.rsqrt(in_deg.clamp_min(1.0)) if self.norm == "both"
                 else 1.0 / in_deg.clamp_min(1.0))
            rst = rst * n.unsqueeze(-1)
        if self.bias is not None:
            rst = rst + self.bias
        if self.activation is not None:
            rst = self.activation(rst)
        return rst


class DenseSAGEConv(nn.Module):
    """(reference ``densesageconv.py:10``): the mean over each row of
    ``adj + I`` (self included), then ``fc`` over ``[feat, mean]``:
    ``nn.Linear(2 in, out)``, Xavier-uniform, zero bias.
    ``forward(adj, feat)``."""

    def __init__(self, in_feats: int, out_feats: int,
                 feat_drop: float = 0.0, bias: bool = True,
                 norm: Optional[Callable] = None,
                 activation: Optional[Callable] = None, *,
                 generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        self.feat_drop = nn.Dropout(feat_drop)
        self.norm, self.activation = norm, activation
        self.fc = dense(2 * in_feats, out_feats, bias, "xavier_uniform",
                        generator)
        self.to(device)

    def forward(self, adj, feat):
        adj = adj.to(feat.dtype)
        adj = adj + torch.eye(adj.shape[-1], dtype=feat.dtype,
                              device=feat.device)
        feat = self.feat_drop(feat)
        in_deg = adj.sum(-1, keepdim=True)
        h = (adj @ feat) / in_deg.clamp_min(1.0)
        rst = self.fc(torch.cat([feat, h], -1))
        if self.activation is not None:
            rst = self.activation(rst)
        if self.norm is not None:
            rst = self.norm(rst)
        return rst


class DenseChebConv(nn.Module):
    """(reference ``densechebconv.py:10``): Chebyshev filters of the scaled
    Laplacian ``(2 / lambda_max) (I - D^-1/2 A D^-1/2) - I`` (in-degrees,
    at least 1; ``lambda_max`` 2 unless given). ``W`` (k, in, out)
    Xavier-normal with flax's fans, ``bias`` zeros.
    ``forward(adj, feat, lambda_max=None)``."""

    def __init__(self, in_feats: int, out_feats: int, k: int,
                 bias: bool = True, *,
                 generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        self.k = k
        self.W = nn.Parameter(flax_init("xavier_normal",
                                        (k, in_feats, out_feats), generator))
        self.bias = nn.Parameter(torch.zeros(out_feats)) if bias else None
        self.to(device)

    def forward(self, adj, feat, lambda_max=None):
        adj = adj.to(feat.dtype)
        n = adj.shape[-1]
        dinv = torch.rsqrt(adj.sum(-1).clamp_min(1.0))
        eye = torch.eye(n, dtype=feat.dtype, device=feat.device)
        lap = eye - dinv.unsqueeze(-1) * adj * dinv.unsqueeze(-2)
        lam = 2.0 if lambda_max is None else lambda_max
        lap_hat = (2.0 / lam) * lap - eye
        t_prev2 = feat
        out = t_prev2 @ self.W[0]
        if self.k > 1:
            t_prev1 = lap_hat @ feat
            out = out + t_prev1 @ self.W[1]
        for i in range(2, self.k):
            t_cur = 2 * (lap_hat @ t_prev1) - t_prev2
            out = out + t_cur @ self.W[i]
            t_prev2, t_prev1 = t_prev1, t_cur
        if self.bias is not None:
            out = out + self.bias
        return out
