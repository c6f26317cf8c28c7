"""Dense multi-head attention with an additive or multiplicative structural
bias (counterpart of ``dgl_tpu/nn/gt/biased_mha.py``; reference
``python/dgl/nn/pytorch/gt/biased_mha.py``), the Graphormer attention
core, on (B, N, D) padded batches."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .._init import dense

__all__ = ["BiasedMHA"]


class BiasedMHA(nn.Module):
    """(reference ``biased_mha.py:9``). ``q_proj``, ``k_proj``, ``v_proj``
    (bias with ``bias``) and ``out_proj`` (always a bias): ``nn.Linear``
    drawn as flax's ``Dense`` default.

    ``forward(ndata, attn_bias=None, attn_mask=None)``: ``attn_bias``
    (B, N, N, H) added to (``"add"``) or multiplied with (``"mul"``) the
    scores; ``attn_mask`` (B, N, N) true where a pair is masked, filled
    with -1e9 (not -inf: a fully masked padding row would give NaN through
    the softmax)."""

    def __init__(self, feat_size: int, num_heads: int, bias: bool = True,
                 attn_bias_type: str = "add", attn_drop: float = 0.1, *,
                 generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        self.feat_size, self.num_heads = feat_size, num_heads
        self.attn_bias_type = attn_bias_type
        for name in ("q_proj", "k_proj", "v_proj"):
            self.add_module(name, dense(feat_size, feat_size, bias,
                                        generator=generator))
        self.out_proj = dense(feat_size, feat_size, generator=generator)
        self.dropout = nn.Dropout(attn_drop)
        self.to(device)

    def forward(self, ndata, attn_bias=None, attn_mask=None):
        H = self.num_heads
        D = self.feat_size // H
        B, N = ndata.shape[0], ndata.shape[1]
        q = self.q_proj(ndata).reshape(B, N, H, D).transpose(1, 2) * D ** -0.5
        k = self.k_proj(ndata).reshape(B, N, H, D).permute(0, 2, 3, 1)
        v = self.v_proj(ndata).reshape(B, N, H, D).transpose(1, 2)
        attn = q @ k  # (B, H, N, N)
        if attn_bias is not None:
            ab = attn_bias.permute(0, 3, 1, 2)
            attn = attn + ab if self.attn_bias_type == "add" else attn * ab
        if attn_mask is not None:
            attn = attn.masked_fill(attn_mask.unsqueeze(1), -1e9)
        attn = self.dropout(torch.softmax(attn, -1))
        out = (attn @ v).transpose(1, 2).reshape(B, N, self.feat_size)
        return self.out_proj(out)
