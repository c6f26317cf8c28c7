"""Graphormer path encoder (counterpart of
``dgl_tpu/nn/gt/path_encoder.py``; reference
``python/dgl/nn/pytorch/gt/path_encoder.py``): an attention bias, the mean
over each shortest path's steps of the step's edge features dotted with a
learned per-step, per-head vector."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .._init import flax_init

__all__ = ["PathEncoder"]


class PathEncoder(nn.Module):
    """(reference ``path_encoder.py:10``). ``embedding_table``
    (max_len * num_heads, feat_dim), normal with standard deviation 0.02.
    ``forward(dist, path_data)``: ``dist`` (B, N, N) path lengths,
    ``path_data`` (B, N, N, L, feat_dim) edge features along each path,
    zero-padded. Output (B, N, N, num_heads), 0 where the length is not
    positive."""

    def __init__(self, max_len: int, feat_dim: int, num_heads: int = 1, *,
                 generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        self.max_len, self.feat_dim, self.num_heads = (max_len, feat_dim,
                                                       num_heads)
        self.embedding_table = nn.Parameter(flax_init(
            "normal", (max_len * num_heads, feat_dim), generator, std=0.02))
        self.to(device)

    def forward(self, dist, path_data):
        shortest = dist.clamp(-1, self.max_len)
        edge_emb = self.embedding_table.reshape(self.max_len, self.num_heads,
                                                self.feat_dim)
        dots = torch.einsum("bxyld,lhd->bxylh",
                            path_data[..., :self.max_len, :], edge_emb)
        steps = torch.arange(dots.shape[-2], device=dist.device)
        valid = steps < shortest.unsqueeze(-1)  # (B, N, N, L)
        summed = (dots * valid.unsqueeze(-1).to(dots.dtype)).sum(-2)
        bias = summed / shortest.clamp_min(1).unsqueeze(-1).to(summed.dtype)
        return torch.where((shortest > 0).unsqueeze(-1), bias,
                           torch.zeros((), dtype=bias.dtype,
                                       device=bias.device))
