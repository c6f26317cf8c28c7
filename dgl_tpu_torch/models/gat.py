"""GAT model (counterpart of ``dgl_tpu/models/gat.py``).

Reference: ``examples/core/gat/train.py``, stacked GATConv layers. On a
graph with a bitmap plan (Reddit-class density) every layer's attention
runs through kernel B3.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..nn.conv.gatconv import GATConv


class GAT(nn.Module):
    """``num_layers`` GATConv layers: the hidden ones with ``heads`` heads,
    ELU and their heads concatenated; the last one with one head, averaged
    over its heads.

    The layers are named ``gat0``, ``gat1``, ... as in the reference, so
    :func:`dgl_tpu_torch.params.from_flax_params` maps its parameters.
    Dropout runs in training mode only. Parameters are drawn on the CPU
    from ``generator`` and each layer is moved to ``device``.
    """

    def __init__(self, in_feats: int, hidden_feats: int, num_classes: int,
                 heads: int = 8, num_layers: int = 2, feat_drop: float = 0.6,
                 attn_drop: float = 0.6, *,
                 generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        self.num_layers = num_layers
        kw = dict(feat_drop=feat_drop, attn_drop=attn_drop,
                  generator=generator, device=device)
        for i in range(num_layers - 1):
            in_f = in_feats if i == 0 else hidden_feats * heads
            self.add_module(f"gat{i}", GATConv(
                in_f, hidden_feats, heads, activation=nn.functional.elu,
                **kw))
        in_f = in_feats if num_layers == 1 else hidden_feats * heads
        self.add_module(f"gat{num_layers - 1}",
                        GATConv(in_f, num_classes, 1, **kw))

    def forward(self, graph, x):
        h = x
        for i in range(self.num_layers - 1):
            h = getattr(self, f"gat{i}")(graph, h)
            h = h.reshape(h.shape[0], -1)  # concatenate the heads
        h = getattr(self, f"gat{self.num_layers - 1}")(graph, h)
        return h.mean(dim=1)
