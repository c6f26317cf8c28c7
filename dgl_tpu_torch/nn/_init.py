"""flax's parameter initialisers, drawn on the CPU from a
``torch.Generator``, so a port module starts from the distribution its
reference module starts from (the parity tests carry the weights across
with ``from_flax_params`` all the same).

flax computes the fans of a parameter from its last two axes, times the
receptive field of the axes before them: a (R, H, D, D) tensor has
fan-in ``D * R * H``. A ``Dense`` kernel is (in, out); the port's
``nn.Linear`` holds its transpose.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

__all__ = ["flax_init", "dense", "embed"]


def _fans(shape):
    if len(shape) < 2:
        n = shape[0] if shape else 1
        return n, n
    receptive = 1
    for d in shape[:-2]:
        receptive *= d
    return shape[-2] * receptive, shape[-1] * receptive


def flax_init(kind: str, shape, generator: Optional[torch.Generator] = None,
              std: float = 1.0) -> torch.Tensor:
    """A tensor of ``shape`` drawn as flax's ``kind`` initialiser draws it:
    ``"xavier_uniform"``, ``"xavier_normal"`` (a normal truncated at two
    standard deviations, as flax's), ``"lecun_normal"`` (the same, fan-in
    only: ``Dense``'s default), ``"normal"`` (``std``) or ``"zeros"``."""
    shape = tuple(shape)
    if kind == "zeros":
        return torch.zeros(shape)
    if kind == "normal":
        return torch.randn(shape, generator=generator) * std
    fan_in, fan_out = _fans(shape)
    if kind == "xavier_uniform":
        bound = math.sqrt(6.0 / (fan_in + fan_out))
        return (torch.rand(shape, generator=generator) * 2 - 1) * bound
    if kind in ("xavier_normal", "lecun_normal"):
        denom = (fan_in + fan_out) / 2 if kind == "xavier_normal" else fan_in
        # flax's truncated normal: the std of a unit normal cut at +-2
        sd = math.sqrt(1.0 / denom) / 0.87962566103423978
        out = torch.empty(shape)
        with torch.no_grad():
            nn.init.trunc_normal_(out, 0.0, sd, -2 * sd, 2 * sd,
                                  generator=generator)
        return out
    raise ValueError(f"unknown initialiser {kind!r}")


def dense(in_feats: int, out_feats: int, bias: bool = True,
          init: str = "lecun_normal",
          generator: Optional[torch.Generator] = None) -> nn.Linear:
    """An ``nn.Linear`` whose weight is drawn as flax's ``Dense`` kernel
    of shape (in, out) with ``init`` (then transposed), its bias zero."""
    lin = nn.Linear(in_feats, out_feats, bias=bias)
    with torch.no_grad():
        lin.weight.copy_(flax_init(init, (in_feats, out_feats),
                                   generator).T)
        if bias:
            lin.bias.zero_()
    return lin


def embed(num: int, dim: int,
          generator: Optional[torch.Generator] = None) -> nn.Embedding:
    """An ``nn.Embedding`` drawn as flax's ``Embed`` draws it: normal with
    standard deviation ``1 / sqrt(dim)``."""
    emb = nn.Embedding(num, dim)
    with torch.no_grad():
        emb.weight.copy_(flax_init("normal", (num, dim), generator,
                                   std=dim ** -0.5))
    return emb
