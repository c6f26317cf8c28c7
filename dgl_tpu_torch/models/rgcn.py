"""R-GCN entity classification (counterpart of ``dgl_tpu/models/rgcn.py``;
reference ``examples/pytorch/rgcn``)."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..nn.conv.relgraphconv import RelGraphConv

__all__ = ["RGCN"]


class RGCN(nn.Module):
    """``num_layers`` RelGraphConv layers ``rgcn0``, ``rgcn1``, ... (the
    basis decomposition when ``num_bases > 0``) with ReLU and dropout
    between them. ``forward(graph, x, etypes)``."""

    def __init__(self, in_feats: int, hidden_feats: int, num_classes: int,
                 num_rels: int, num_bases: int = -1, num_layers: int = 2,
                 self_loop: bool = True, dropout: float = 0.0, *,
                 generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        dims = ([in_feats] + [hidden_feats] * (num_layers - 1)
                + [num_classes])
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"rgcn{i}", RelGraphConv(
                dims[i], dims[i + 1], num_rels,
                regularizer="basis" if num_bases > 0 else None,
                num_bases=num_bases if num_bases > 0 else None,
                self_loop=self_loop, generator=generator, device=device))
        self.dropout = nn.Dropout(dropout)

    def forward(self, graph, x, etypes):
        h = x
        for i in range(self.num_layers):
            h = getattr(self, f"rgcn{i}")(graph, h, etypes)
            if i != self.num_layers - 1:
                h = self.dropout(torch.relu(h))
        return h
