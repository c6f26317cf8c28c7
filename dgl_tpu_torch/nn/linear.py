"""Typed and per-type linear layers (counterpart of ``dgl_tpu/nn/linear.py``;
reference ``python/dgl/nn/pytorch/linear.py``)."""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ..base import DGLError
from ..ops import gather_mm, segment_mm
from ._init import dense, flax_init
from .utils_nn import module_key

__all__ = ["TypedLinear", "HeteroLinear", "HeteroEmbedding",
           "matmul_maybe_select", "bmm_maybe_select"]


class TypedLinear(nn.Module):
    """A linear transform per type (reference ``linear.py:13``).

    ``weight`` (T, in, out), or with ``regularizer="basis"`` ``basis``
    (B, in, out) and ``coeff`` (T, B) combined as
    ``einsum("rb,bio->rio")``, shaped and named as the reference's flax
    parameters, Xavier-uniform as there. ``forward(x, x_type,
    sorted_by_type=False, seglen=None)``: rows already sorted by type with
    their ``seglen`` take ``ops.segment_mm``, any others ``ops.gather_mm``.
    """

    def __init__(self, in_size: int, out_size: int, num_types: int,
                 regularizer: Optional[str] = None,
                 num_bases: Optional[int] = None, *,
                 generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        if regularizer not in (None, "basis"):
            raise DGLError(f"Unsupported regularizer {regularizer!r}; use "
                           "None or 'basis'")
        self.in_size, self.out_size = in_size, out_size
        self.num_types = num_types
        self.regularizer = regularizer
        if regularizer == "basis":
            nb = num_bases or num_types
            self.basis = nn.Parameter(flax_init(
                "xavier_uniform", (nb, in_size, out_size), generator))
            self.coeff = nn.Parameter(flax_init(
                "xavier_uniform", (num_types, nb), generator))
        else:
            self.weight = nn.Parameter(flax_init(
                "xavier_uniform", (num_types, in_size, out_size), generator))
        self.to(device)

    def get_weight(self) -> torch.Tensor:
        """The (T, in, out) weights."""
        if self.regularizer == "basis":
            return torch.einsum("rb,bio->rio", self.coeff, self.basis)
        return self.weight

    def forward(self, x, x_type, sorted_by_type: bool = False,
                seglen=None):
        w = self.get_weight()
        if sorted_by_type and seglen is not None:
            return segment_mm(x, w, seglen)
        return gather_mm(x, w, x_type)


class HeteroLinear(nn.Module):
    """One ``nn.Linear`` a type (reference ``linear.py:123``).

    ``in_size`` maps each type to its input width. The linears live in
    ``self.linears`` under ``module_key(type)`` (the reference's flax
    names them ``linear_<type>``); Xavier-uniform weights, zero bias.
    ``forward(feat)`` maps a dict of per-type inputs to their outputs."""

    def __init__(self, in_size: Dict[str, int], out_size: int,
                 use_bias: bool = True, *,
                 generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        self.out_size = out_size
        self.linears = nn.ModuleDict({
            module_key(t): dense(n, out_size, use_bias, "xavier_uniform",
                                 generator)
            for t, n in in_size.items()})
        self.to(device)

    def forward(self, feat: Dict[str, torch.Tensor]):
        return {t: _child(self.linears, t)(x) for t, x in feat.items()}


class HeteroEmbedding(nn.Module):
    """One embedding table a type (reference ``linear.py:197``).

    The tables live in ``self.embeds`` under ``module_key(type)`` (flax:
    ``embed_<type>``), each an ``nn.Embedding`` drawn as flax's ``Embed``
    draws it: normal with standard deviation ``1 / sqrt(dim)``.
    ``forward(ids)`` maps a dict of per-type id tensors to their rows."""

    def __init__(self, num_embeddings: Dict[str, int], embedding_dim: int, *,
                 generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        self.embedding_dim = embedding_dim
        embeds = {}
        for t, n in num_embeddings.items():
            emb = nn.Embedding(n, embedding_dim)
            with torch.no_grad():
                emb.weight.copy_(flax_init("normal", (n, embedding_dim),
                                           generator,
                                           std=embedding_dim ** -0.5))
            embeds[module_key(t)] = emb
        self.embeds = nn.ModuleDict(embeds)
        self.to(device)

    def forward(self, ids: Dict[str, torch.Tensor]):
        return {t: _child(self.embeds, t)(idx) for t, idx in ids.items()}


def _child(mods: nn.ModuleDict, typ: str) -> nn.Module:
    key = module_key(typ)
    if key not in mods:
        raise DGLError(f"No module for type {typ!r}")
    return mods[key]


def _is_int(t: torch.Tensor) -> bool:
    return not (t.dtype.is_floating_point or t.dtype.is_complex
                or t.dtype == torch.bool)


def matmul_maybe_select(A, B):
    """``A @ B``, or the rows ``B[A]`` when ``A`` holds integer ids
    (reference ``python/dgl/nn/pytorch/utils.py:14``)."""
    if _is_int(A):
        return B.index_select(0, A.to(torch.int64))
    return A @ B


def bmm_maybe_select(A, B, index):
    """``A[i] @ B[index[i]]`` for each row, or the row ``B[index[i],
    A[i]]`` when ``A`` holds integer ids (reference
    ``nn/pytorch/utils.py:54``). The product goes through
    ``ops.gather_mm``, which builds no (N, in, out) tensor."""
    index = index.to(torch.int64)
    if _is_int(A):
        return B[index, A.to(torch.int64)]
    return gather_mm(A, B, index)
