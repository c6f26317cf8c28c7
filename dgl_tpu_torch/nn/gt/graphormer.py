"""Graphormer layer (counterpart of ``dgl_tpu/nn/gt/graphormer.py``;
reference ``python/dgl/nn/pytorch/gt/graphormer.py``): ``BiasedMHA`` and a
feed-forward block, with layer norm before or after each."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .._init import dense
from .biased_mha import BiasedMHA

__all__ = ["GraphormerLayer"]


class GraphormerLayer(nn.Module):
    """(reference ``graphormer.py:9``). ``attn`` (``BiasedMHA``),
    ``attn_layer_norm`` and ``ffn_layer_norm`` (flax's epsilon 1e-6),
    ``ffn0`` (to ``hidden_size``, ReLU) and ``ffn1``; dropout after each
    ffn layer. ``activation`` is kept for the reference's signature; the
    reference applies ReLU. ``forward(nfeat, attn_bias=None,
    attn_mask=None)``."""

    def __init__(self, feat_size: int, hidden_size: int, num_heads: int,
                 attn_bias_type: str = "add", norm_first: bool = False,
                 dropout: float = 0.1, attn_dropout: float = 0.1,
                 activation=torch.relu, *,
                 generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        self.norm_first = norm_first
        self.attn = BiasedMHA(feat_size, num_heads,
                              attn_bias_type=attn_bias_type,
                              attn_drop=attn_dropout, generator=generator,
                              device=device)
        self.attn_layer_norm = nn.LayerNorm(feat_size, eps=1e-6)
        self.ffn_layer_norm = nn.LayerNorm(feat_size, eps=1e-6)
        self.ffn0 = dense(feat_size, hidden_size, generator=generator)
        self.ffn1 = dense(hidden_size, feat_size, generator=generator)
        self.dropout = nn.Dropout(dropout)
        self.to(device)

    def _ffn(self, x):
        return self.dropout(self.ffn1(self.dropout(torch.relu(
            self.ffn0(x)))))

    def forward(self, nfeat, attn_bias=None, attn_mask=None):
        if self.norm_first:
            h = nfeat + self.attn(self.attn_layer_norm(nfeat), attn_bias,
                                  attn_mask)
            return h + self._ffn(self.ffn_layer_norm(h))
        h = self.attn_layer_norm(nfeat + self.attn(nfeat, attn_bias,
                                                   attn_mask))
        return self.ffn_layer_norm(h + self._ffn(h))
