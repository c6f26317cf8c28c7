"""GraphSAGE model (counterpart of ``dgl_tpu/models/sage.py``).

Reference: ``examples/graphbolt/node_classification.py``. Takes one graph
(full-graph training, through the hub or plain g-SpMM) or a list of MFG
blocks, innermost first (minibatch training: the blocks of
``dataloading.FixedShapeNeighborSampler``, through the uniform-stride
g-SpMM).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..nn.conv.sageconv import SAGEConv


class GraphSAGE(nn.Module):
    """``num_layers`` SAGEConv layers, ReLU and dropout between them.

    The layers are named ``sage0``, ``sage1``, ... as in the reference, so
    :func:`dgl_tpu_torch.params.from_flax_params` maps its parameters.
    Parameters are drawn on the CPU from ``generator`` and each layer is
    then moved to ``device``.
    """

    def __init__(self, in_feats: int, hidden_feats: int, num_classes: int,
                 num_layers: int = 3, aggregator_type: str = "mean",
                 dropout: float = 0.5, *,
                 generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        self.num_layers = num_layers
        dims = [in_feats] + [hidden_feats] * (num_layers - 1) + [num_classes]
        for i in range(num_layers):
            self.add_module(f"sage{i}", SAGEConv(
                dims[i], dims[i + 1], aggregator_type=aggregator_type,
                generator=generator, device=device))
        self.dropout = nn.Dropout(dropout)

    def forward(self, graph_or_blocks, x):
        blocks = (graph_or_blocks
                  if isinstance(graph_or_blocks, (list, tuple))
                  else [graph_or_blocks] * self.num_layers)
        h = x
        for i, block in enumerate(blocks):
            h = getattr(self, f"sage{i}")(block, h)
            if i != self.num_layers - 1:
                h = self.dropout(torch.relu(h))
        return h
