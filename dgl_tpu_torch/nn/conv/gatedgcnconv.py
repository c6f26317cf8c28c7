"""Gated GCN / ResGatedGCN layer (counterpart of
``dgl_tpu/nn/conv/gatedgcnconv.py``; reference
``python/dgl/nn/pytorch/conv/gatedgcnconv.py``): edge gates
``e' = D h_u + E h_v + C e``; ``h' = A h_v + sum(sigma(e') * B h_u) /
(sum sigma(e') + 1e-6)``. The gate is a ``u_add_v`` g-SDDMM, both sums
g-SpMM (``u_mul_e`` and ``copy_e``)."""
from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from ... import function as fn
from .._init import dense

__all__ = ["GatedGCNConv"]


class GatedGCNConv(nn.Module):
    """(reference ``gatedgcnconv.py:12``). ``A`` .. ``E``: ``nn.Linear``
    with bias, drawn as flax's Xavier-normal (truncated at two standard
    deviations), zero biases; with ``batch_norm``, ``bn_h`` and ``bn_e``
    are ``LayerNorm``s (flax's epsilon 1e-6), as in the reference.
    ``forward(graph, feat, edge_feat)`` returns ``(h', e')``."""

    def __init__(self, input_feats: int, edge_feats: int, output_feats: int,
                 dropout: float = 0.0, batch_norm: bool = True,
                 residual: bool = True, activation: Callable = torch.relu,
                 *, generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        self.input_feats, self.edge_feats = input_feats, edge_feats
        self.output_feats = output_feats
        for name, width in (("A", input_feats), ("B", input_feats),
                            ("C", edge_feats), ("D", input_feats),
                            ("E", input_feats)):
            self.add_module(name, dense(width, output_feats, True,
                                        "xavier_normal", generator))
        self.bn_h = self.bn_e = None
        if batch_norm:
            self.bn_h = nn.LayerNorm(output_feats, eps=1e-6)
            self.bn_e = nn.LayerNorm(output_feats, eps=1e-6)
        self.residual = residual
        self.activation = activation
        self.dropout = nn.Dropout(dropout)
        self.to(device)

    def forward(self, graph, feat, edge_feat):
        with graph.local_scope() as g:
            h, e = feat, edge_feat
            h_dst = h[:g.num_dst_nodes()]
            g.srcdata["Dh"] = self.D(h)
            g.dstdata["Eh"] = self.E(h_dst)
            g.edata["Ce"] = self.C(e)
            g.apply_edges(fn.u_add_v("Dh", "Eh", "DEh"))
            e_new = g.edata["DEh"] + g.edata["Ce"]
            g.edata["sigma"] = torch.sigmoid(e_new)
            g.srcdata["Bh"] = self.B(h)
            g.update_all(fn.u_mul_e("Bh", "sigma", "m"),
                         fn.sum("m", "sum_sigma_h"))
            g.update_all(fn.copy_e("sigma", "m"), fn.sum("m", "sum_sigma"))
            h_new = self.A(h_dst) + g.dstdata["sum_sigma_h"] / (
                g.dstdata["sum_sigma"] + 1e-6)
            if self.bn_h is not None:
                h_new, e_new = self.bn_h(h_new), self.bn_e(e_new)
            h_new = self.activation(h_new)
            e_new = self.activation(e_new)
            if self.residual and self.input_feats == self.output_feats:
                h_new = h_dst + h_new
            if self.residual and self.edge_feats == self.output_feats:
                e_new = e + e_new
            return self.dropout(h_new), self.dropout(e_new)
