"""Graphormer degree encoder (counterpart of
``dgl_tpu/nn/gt/degree_encoder.py``; reference
``python/dgl/nn/pytorch/gt/degree_encoder.py``): learned embeddings of the
clipped in and out degrees."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .._init import embed

__all__ = ["DegreeEncoder"]


class DegreeEncoder(nn.Module):
    """(reference ``degree_encoder.py:10``). ``degrees`` (B, N), or
    (B, N, 2) in and out degrees, clipped to [0, max_degree].
    ``direction`` ``"both"`` sums ``encoder1``'s rows of both columns
    (of the one column for 2-D input), ``"in"`` takes ``encoder1`` of the
    in-degrees, ``"out"`` ``encoder2`` of the out-degrees. Output
    (B, N, embedding_dim)."""

    def __init__(self, max_degree: int, embedding_dim: int,
                 direction: str = "both", *,
                 generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        if direction not in ("both", "in", "out"):
            raise ValueError(f"Unknown direction {direction!r}")
        self.max_degree, self.direction = max_degree, direction
        name = "encoder2" if direction == "out" else "encoder1"
        self.add_module(name, embed(max_degree + 1, embedding_dim,
                                    generator))
        self.to(device)

    def forward(self, degrees):
        clipped = degrees.clamp(0, self.max_degree).to(torch.int64)
        if self.direction == "both":
            if clipped.dim() == 3:
                return self.encoder1(clipped).sum(-2)
            return self.encoder1(clipped)
        if self.direction == "in":
            return self.encoder1(clipped[..., 0] if clipped.dim() == 3
                                 else clipped)
        return self.encoder2(clipped[..., 1] if clipped.dim() == 3
                             else clipped)
