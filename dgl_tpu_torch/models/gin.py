"""GIN graph classification (counterpart of ``dgl_tpu/models/gin.py``;
reference ``examples/pytorch/gin/train.py``): GIN layers with two-layer
MLPs, a readout of every layer and the layers' logits summed."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..nn._init import dense
from ..nn.conv.ginconv import GINConv
from ..readout import mean_nodes, sum_nodes


class _MLP(nn.Module):
    """``linear1(relu(norm(linear0(x))))``, the layer norm at flax's
    epsilon (the reference's ``Dense_0``, ``LayerNorm_0``, ``Dense_1``)."""

    def __init__(self, in_feats: int, hidden: int, out: int, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.linear0 = dense(in_feats, hidden, generator=generator)
        self.norm = nn.LayerNorm(hidden, eps=1e-6)
        self.linear1 = dense(hidden, out, generator=generator)

    def forward(self, x):
        return self.linear1(torch.relu(self.norm(self.linear0(x))))


class GIN(nn.Module):
    """Per-graph logits of a batched graph (reference model): layer ``i``
    is ``relu(mlp<i>(gin<i>(g, h)))`` (a ``GINConv`` with sum, and its own
    ``eps`` with ``learn_eps``), read out by ``readout`` (``"sum"`` or
    mean), dropped out and projected by ``pred<i>``; the logits are the
    sum over layers. The layers keep the reference's names, so
    ``from_flax_params`` carries its parameters over."""

    def __init__(self, in_feats: int, hidden_feats: int, num_classes: int,
                 num_layers: int = 5, dropout: float = 0.5,
                 readout: str = "sum", learn_eps: bool = False, *,
                 generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        self.num_layers = num_layers
        self.pool = sum_nodes if readout == "sum" else mean_nodes
        for i in range(num_layers):
            self.add_module(f"gin{i}", GINConv(learn_eps=learn_eps,
                                               device=device))
            self.add_module(f"mlp{i}", _MLP(
                in_feats if i == 0 else hidden_feats, hidden_feats,
                hidden_feats, generator=generator))
            self.add_module(f"pred{i}", dense(hidden_feats, num_classes,
                                              generator=generator))
        self.dropout = nn.Dropout(dropout)
        self.to(device)

    def forward(self, graph, x):
        score = 0.0
        h = x
        for i in range(self.num_layers):
            h = torch.relu(getattr(self, f"mlp{i}")(
                getattr(self, f"gin{i}")(graph, h)))
            with graph.local_scope() as g:
                g.ndata["_gin_h"] = h
                hg = self.pool(g, "_gin_h")
            score = score + getattr(self, f"pred{i}")(self.dropout(hg))
        return score
