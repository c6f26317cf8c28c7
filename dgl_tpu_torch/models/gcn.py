"""GCN model (counterpart of ``dgl_tpu/models/gcn.py``).

Reference: ``examples/core/gcn/train.py``, two GraphConv layers. On a
graph with a bitmap plan (Reddit-class density) every layer's aggregation
runs through kernel B2.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..nn.conv.graphconv import GraphConv


class GCN(nn.Module):
    """``num_layers`` GraphConv layers (norm "both"), ReLU and dropout
    between them; dropout is off in eval mode.

    The layers are named ``conv0``, ``conv1``, ... as in the reference, so
    :func:`dgl_tpu_torch.params.from_flax_params` maps its parameters. With
    ``static_input_agg=True``, pass ``x = precompute_graphconv(graph,
    raw_x)`` and layer 0 skips its g-SpMM (an exact rewrite: the
    aggregation is linear and the input is constant). Parameters are drawn
    on the CPU from ``generator`` and each layer is moved to ``device``.
    """

    def __init__(self, in_feats: int, hidden_feats: int, num_classes: int,
                 num_layers: int = 2, dropout: float = 0.5,
                 static_input_agg: bool = False, *,
                 generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        self.num_layers = num_layers
        self.static_input_agg = static_input_agg
        dims = [in_feats] + [hidden_feats] * (num_layers - 1) + [num_classes]
        for i in range(num_layers):
            self.add_module(f"conv{i}", GraphConv(
                dims[i], dims[i + 1], generator=generator, device=device))
        self.dropout = nn.Dropout(dropout)

    def forward(self, graph, x):
        for i in range(self.num_layers):
            x = getattr(self, f"conv{i}")(
                graph, x, precomputed=(i == 0 and self.static_input_agg))
            if i != self.num_layers - 1:
                x = self.dropout(torch.relu(x))
        return x
