"""Spectral-style convolutions: SGConv, APPNPConv, TAGConv, ChebConv
(counterpart of ``dgl_tpu/nn/conv/spectral.py``; reference
``python/dgl/nn/pytorch/conv/{sgconv,appnpconv,tagconv,chebconv}.py``).

Each is a sequence of symmetric-normalised hops ``D^-1/2 A D^-1/2 x``,
one ``update_all(copy_u, sum)`` a hop: on a graph with a hub plan, one
launch of kernel B1 a hop (``k`` a layer; APPNP's default is 10).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from ... import function as fn
from .._init import dense

__all__ = ["SGConv", "APPNPConv", "TAGConv", "ChebConv"]


def _rsqrt(x):
    """``1 / sqrt(x)``, as the reference's ``jax_rsqrt`` computes it."""
    return 1.0 / torch.sqrt(x)


def _sym_norm_hop(g, x, msg_fn=None):
    """One ``D^-1/2 A D^-1/2`` hop through g-SpMM, degrees clamped at 1."""
    shape = (-1,) + (1,) * (x.dim() - 1)
    degs_out = torch.clamp(g.out_degrees().to(x.dtype), min=1)
    degs_in = torch.clamp(g.in_degrees().to(x.dtype), min=1)
    g.srcdata["_h"] = x * _rsqrt(degs_out).reshape(shape)
    g.update_all(msg_fn or fn.copy_u("_h", "m"), fn.sum("m", "_h"))
    return g.dstdata["_h"] * _rsqrt(degs_in).reshape(shape)


class SGConv(nn.Module):
    """Simplified GCN, ``(D^-1/2 A D^-1/2)^k X W`` (reference
    ``sgconv.py``). ``fc``: ``nn.Linear``, Xavier-uniform.
    ``forward(graph, feat, edge_weight=None)``: with edge weights each hop
    is ``u_mul_e``."""

    def __init__(self, in_feats: int, out_feats: int, k: int = 1,
                 bias: bool = True, *,
                 generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        self.k = k
        self.fc = dense(in_feats, out_feats, bias, "xavier_uniform",
                        generator)
        self.to(device)

    def forward(self, graph, feat, edge_weight=None):
        with graph.local_scope() as g:
            msg_fn = None
            if edge_weight is not None:
                g.edata["_ew"] = edge_weight
                msg_fn = fn.u_mul_e("_h", "_ew", "m")
            h = feat
            for _ in range(self.k):
                h = _sym_norm_hop(g, h, msg_fn)
            return self.fc(h)


class APPNPConv(nn.Module):
    """Approximate personalised PageRank propagation (reference
    ``appnpconv.py``): ``h <- (1 - alpha) hop(h) + alpha h0``, ``k``
    times. No parameters; ``edge_drop`` is kept, unused, as the
    reference's."""

    def __init__(self, k: int = 10, alpha: float = 0.1,
                 edge_drop: float = 0.0):
        super().__init__()
        self.k, self.alpha, self.edge_drop = k, alpha, edge_drop

    def forward(self, graph, feat):
        with graph.local_scope() as g:
            h = feat
            for _ in range(self.k):
                h = (1 - self.alpha) * _sym_norm_hop(g, h) + self.alpha * feat
            return h


class TAGConv(nn.Module):
    """Topology-adaptive GCN (reference ``tagconv.py``): ``lin`` over the
    concatenated hops 0..k."""

    def __init__(self, in_feats: int, out_feats: int, k: int = 2,
                 bias: bool = True, activation: Optional[Callable] = None,
                 *, generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        self.k = k
        self.activation = activation
        self.lin = dense(in_feats * (k + 1), out_feats, bias,
                         "xavier_uniform", generator)
        self.to(device)

    def forward(self, graph, feat):
        with graph.local_scope() as g:
            hops = [feat]
            for _ in range(self.k):
                hops.append(_sym_norm_hop(g, hops[-1]))
            rst = self.lin(torch.cat(hops, dim=-1))
            if self.activation is not None:
                rst = self.activation(rst)
            return rst


class ChebConv(nn.Module):
    """Chebyshev spectral convolution (reference ``chebconv.py``) with the
    scaled Laplacian ``(2 / lambda_max)(x - hop(x)) - x``, ``lambda_max``
    2 unless given. ``w0`` .. ``w{k-1}``: ``nn.Linear`` without bias,
    Xavier-uniform; ``bias`` (out,) zeros."""

    def __init__(self, in_feats: int, out_feats: int, k: int = 2,
                 bias: bool = True, activation: Optional[Callable] = None,
                 *, generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        self.k = k
        self.activation = activation
        for i in range(k):
            self.add_module(f"w{i}", dense(in_feats, out_feats, False,
                                           "xavier_uniform", generator))
        self.bias = nn.Parameter(torch.zeros(out_feats)) if bias else None
        self.to(device)

    def forward(self, graph, feat, lambda_max=None):
        lam = 2.0 if lambda_max is None else lambda_max
        with graph.local_scope() as g:
            def laplacian_hop(x):
                return (2.0 / lam) * (x - _sym_norm_hop(g, x)) - x

            out = self.w0(feat)
            if self.k > 1:
                tk_prev, tk = feat, laplacian_hop(feat)
                out = out + self.w1(tk)
                for i in range(2, self.k):
                    tk_prev, tk = tk, 2 * laplacian_hop(tk) - tk_prev
                    out = out + getattr(self, f"w{i}")(tk)
            if self.bias is not None:
                out = out + self.bias
            if self.activation is not None:
                out = self.activation(out)
            return out
