"""Graphormer spatial encoders (counterpart of
``dgl_tpu/nn/gt/spatial_encoder.py``; reference
``python/dgl/nn/pytorch/gt/spatial_encoder.py``): a learned attention bias
per clipped shortest-path distance, and the 3D one from Gaussian basis
kernels of pairwise distances."""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from .._init import dense, embed

__all__ = ["SpatialEncoder", "SpatialEncoder3d", "gaussian"]


class SpatialEncoder(nn.Module):
    """(reference ``spatial_encoder.py:10``). ``dist`` (B, N, N), -1 where
    unreachable, bucketed as ``clip(dist, -1, max_dist) + 1`` into
    ``embedding`` (max_dist + 2, num_heads); output (B, N, N, num_heads)."""

    def __init__(self, max_dist: int, num_heads: int = 1, *,
                 generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        self.max_dist = max_dist
        self.embedding = embed(max_dist + 2, num_heads, generator)
        self.to(device)

    def forward(self, dist):
        return self.embedding(dist.clamp(-1, self.max_dist).to(torch.int64)
                              + 1)


class SpatialEncoder3d(nn.Module):
    """3D spatial attention bias (reference ``spatial_encoder.py:88``,
    Transformer-M): per pair, ``gamma * |x_i - x_j| + beta`` (``gamma``
    and ``beta`` learned per (source type, target type), summed over the
    two), Gaussian kernels of learned ``means`` and ``stds`` (uniform in
    [0, 3)), ``proj1``, tanh-approximated GELU (JAX's default) and
    ``proj2``. ``forward(coord (B, N, 3), node_type (B, N) or None)``
    gives (B, N, N, num_heads)."""

    def __init__(self, num_kernels: int, num_heads: int = 1,
                 max_node_type: int = 100, *,
                 generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        self.num_kernels, self.max_node_type = num_kernels, max_node_type
        self.gamma = embed(2 * max_node_type + 4, 1, generator)
        self.beta = embed(2 * max_node_type + 4, 1, generator)
        self.means = nn.Parameter(torch.rand(num_kernels,
                                             generator=generator) * 3.0)
        self.stds = nn.Parameter(torch.rand(num_kernels,
                                            generator=generator) * 3.0)
        self.proj1 = dense(num_kernels, num_kernels, generator=generator)
        self.proj2 = dense(num_kernels, num_heads, generator=generator)
        self.to(device)

    def forward(self, coord, node_type=None):
        B, N = coord.shape[:2]
        diff = coord.unsqueeze(2) - coord.unsqueeze(1)
        euc = torch.sqrt((diff * diff).sum(-1) + 1e-12)  # (B, N, N)
        if node_type is None:
            nt = torch.zeros((B, N, N, 2), dtype=torch.int64,
                             device=coord.device)
        else:
            t = node_type.to(torch.int64)
            nt = torch.stack([t.unsqueeze(2).expand(B, N, N) + 2,
                              t.unsqueeze(1).expand(B, N, N)
                              + self.max_node_type + 3], -1)
        gamma = self.gamma(nt).sum(-2)  # (B, N, N, 1)
        beta = self.beta(nt).sum(-2)
        scaled = gamma * euc.unsqueeze(-1) + beta
        sigma = torch.abs(self.stds) + 1e-2
        x = (scaled - self.means) / sigma
        gauss = torch.exp(-0.5 * x * x) / (math.sqrt(2 * math.pi) * sigma)
        h = torch.nn.functional.gelu(self.proj1(gauss), approximate="tanh")
        return self.proj2(h)


def gaussian(x, mean, std):
    """Gaussian basis value (reference ``gt/spatial_encoder.py:8``)."""
    const = 0.3989422804014327  # 1 / sqrt(2 pi)
    std = std + 1e-2
    return torch.exp(-0.5 * (((x - mean) / std) ** 2)) * (const / std)
