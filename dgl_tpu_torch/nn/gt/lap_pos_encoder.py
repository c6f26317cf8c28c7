"""Laplacian positional encoder (counterpart of
``dgl_tpu/nn/gt/lap_pos_encoder.py``; reference
``python/dgl/nn/pytorch/gt/lap_pos_encoder.py``): the k smallest
eigenvectors and eigenvalues, per node, through a linear map and a
transformer or DeepSet over the frequency axis, summed over it."""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from .._init import dense, flax_init

__all__ = ["LapPosEncoder"]


class _DenseGeneral(nn.Module):
    """flax's ``DenseGeneral`` as ``from_flax_params`` carries it: the
    kernel's axes reversed into ``weight``, the bias as it is."""

    def __init__(self, kernel_shape, bias_shape, n_in: int, generator):
        super().__init__()
        self.n_in = n_in
        k = flax_init("lecun_normal", (math.prod(kernel_shape[:n_in]),
                                       math.prod(kernel_shape[n_in:])),
                      generator).reshape(kernel_shape)
        self.weight = nn.Parameter(k.permute(
            *reversed(range(len(kernel_shape)))).contiguous())
        self.bias = nn.Parameter(torch.zeros(bias_shape))

    def forward(self, x):
        k = self.weight.permute(*reversed(range(self.weight.dim())))
        nd = k.dim() - self.n_in
        out = torch.tensordot(x, k, dims=self.n_in)
        return out + self.bias.reshape((1,) * (out.dim() - nd)
                                       + tuple(self.bias.shape))


class _SelfAttention(nn.Module):
    """flax's ``SelfAttention(num_heads)`` at its defaults (queries, keys
    and values of the input's width, no dropout): ``query``, ``key``,
    ``value`` (dim -> heads x dim / heads) and ``out`` back to dim."""

    def __init__(self, dim: int, heads: int, generator):
        super().__init__()
        hd = dim // heads
        for name in ("query", "key", "value"):
            self.add_module(name, _DenseGeneral((dim, heads, hd),
                                                (heads, hd), 1, generator))
        self.out = _DenseGeneral((heads, hd, dim), (dim,), 2, generator)

    def forward(self, x):
        q, k, v = self.query(x), self.key(x), self.value(x)
        q = q / q.shape[-1] ** 0.5
        w = torch.softmax(torch.einsum("...qhd,...khd->...hqk", q, k), -1)
        return self.out(torch.einsum("...hqk,...khd->...qhd", w, v))


class LapPosEncoder(nn.Module):
    """(reference ``lap_pos_encoder.py:9``). ``forward(eigvals, eigvecs)``,
    both (N, k): the (N, k, 2) pairs (NaN frequencies masked to 0 and left
    out of the sum) through ``linear_a`` (to ``dim``), then
    ``num_layer`` residual self-attention layers ``attn<i>``
    (``"Transformer"``) or ``ds<i>`` linear + ReLU layers (``"DeepSet"``),
    the sum over the frequencies, and ``num_post_layer`` layers
    ``post<i>`` (ReLU between). ``batch_norm`` is kept for the
    reference's signature and unused, as there."""

    def __init__(self, model_type: str, num_layer: int, k: int, dim: int,
                 n_head: int = 1, batch_norm: bool = False,
                 num_post_layer: int = 0, *,
                 generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        self.model_type, self.num_layer = model_type, num_layer
        self.num_post_layer = num_post_layer
        self.linear_a = dense(2, dim, generator=generator)
        for i in range(num_layer):
            if model_type == "Transformer":
                self.add_module(f"attn{i}", _SelfAttention(dim, n_head,
                                                           generator))
            else:
                self.add_module(f"ds{i}", dense(dim, dim,
                                                generator=generator))
        for i in range(num_post_layer):
            self.add_module(f"post{i}", dense(dim, dim, generator=generator))
        self.to(device)

    def forward(self, eigvals, eigvecs):
        pos = torch.stack([eigvecs, eigvals], -1)
        nan = torch.isnan(pos)
        mask = nan.any(-1)
        pos = torch.where(nan, torch.zeros((), dtype=pos.dtype,
                                           device=pos.device), pos)
        h = self.linear_a(pos)
        for i in range(self.num_layer):
            if self.model_type == "Transformer":
                h = h + getattr(self, f"attn{i}")(h)
            else:
                h = torch.relu(getattr(self, f"ds{i}")(h))
        h = torch.where(mask.unsqueeze(-1), torch.zeros(
            (), dtype=h.dtype, device=h.device), h).sum(-2)
        for i in range(self.num_post_layer):
            h = getattr(self, f"post{i}")(h)
            if i < self.num_post_layer - 1:
                h = torch.relu(h)
        return h
