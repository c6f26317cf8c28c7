"""nn utilities (counterpart of ``dgl_tpu/nn/utils_nn.py``; reference
``python/dgl/nn/pytorch/conv/graphconv.py:16`` and
``python/dgl/nn/pytorch/utils.py``)."""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from .. import function as fn
from .. import ops
from ..base import DGLError
from ._init import flax_init

__all__ = ["EdgeWeightNorm", "Identity", "JumpingKnowledge",
           "LabelPropagation", "Sequential", "WeightBasis", "module_key",
           "pad_edges"]

# names a key of an nn.ModuleDict must not take: its attributes and
# methods ("type", "to", "train", "keys", ...)
_RESERVED = frozenset(dir(nn.ModuleDict()))
_ESC = "~"


def module_key(name: str) -> str:
    """A legal ``nn.ModuleDict`` key for a node or edge type ``name``.

    A name that is not empty, holds no ``.``, names no attribute of
    ``nn.ModuleDict`` and does not start with ``~`` stays as it is, so
    ``mods.<etype>`` keeps the type's name. Any other becomes ``~`` and the
    name with ``~`` written ``~~`` and ``.`` written ``~d``: ``"a.b"`` is
    ``"~a~db"``, ``"type"`` is ``"~type"`` and ``""`` is ``"~"``. Distinct
    names get distinct keys."""
    if name and "." not in name and name not in _RESERVED and not (
            name.startswith(_ESC)):
        return name
    return _ESC + name.replace(_ESC, _ESC * 2).replace(".", _ESC + "d")


class EdgeWeightNorm(nn.Module):
    """Normalise scalar edge weights as GCN's symmetric norm does.

    ``norm="both"`` gives ``w_uv / sqrt(deg_u * deg_v)`` with weighted
    degrees; ``"right"`` ``w_uv / deg_v``. The destination degrees are a
    ``copy_rhs`` sum over the relation (through its shell plan where it has
    one), the source degrees the same over ``rel.reverse()``, which carries
    no plan. A degree of 0 gives 0. No parameters.
    """

    def __init__(self, norm: str = "both", eps: float = 0.0):
        super().__init__()
        if norm not in ("both", "right"):
            raise DGLError(f"Unknown norm {norm!r}")
        self.norm = norm
        self.eps = eps

    def forward(self, graph, edge_weight):
        if edge_weight.dim() > 1:
            raise DGLError("edge_weight must be 1D (scalar per edge)")
        rel = graph._relation()
        w = edge_weight
        deg_dst = ops.gspmm(rel, "copy_rhs", "sum", None, w) + self.eps
        src, dst = _clamped(rel.src, rel.num_src), _clamped(rel.dst,
                                                            rel.num_dst)
        if self.norm == "both":
            deg_src = ops.gspmm(rel.reverse(), "copy_rhs", "sum", None,
                                w) + self.eps
            inv_src = torch.where(deg_src > 0, 1.0 / torch.sqrt(deg_src), 0.0)
            inv_dst = torch.where(deg_dst > 0, 1.0 / torch.sqrt(deg_dst), 0.0)
            return w * inv_src.index_select(0, src) * inv_dst.index_select(
                0, dst)
        inv = torch.where(deg_dst > 0, 1.0 / deg_dst, 0.0)
        return w * inv.index_select(0, dst)


class Identity(nn.Module):
    """Returns its input (reference ``nn/pytorch/utils.py:99``)."""

    def forward(self, x):
        return x


class Sequential(nn.Module):
    """Graph-aware sequential container (reference ``utils.py:113``):
    each layer is called as ``layer(graph, *feats)``, a tuple result
    feeding the next layer's arguments. The layers live in ``layers``
    (flax: ``layers_<i>``)."""

    def __init__(self, *layers: nn.Module):
        super().__init__()
        self.layers = nn.ModuleList(layers)

    def forward(self, graph, *feats):
        for layer in self.layers:
            feats = layer(graph, *feats)
            if not isinstance(feats, tuple):
                feats = (feats,)
        return feats[0] if len(feats) == 1 else feats


class WeightBasis(nn.Module):
    """Basis-decomposed weight bank (reference ``utils.py:235``):
    ``W_o = sum_b w_comp[o, b] weight[b]``. ``weight`` (num_bases,
    *shape) and ``w_comp`` (num_outputs, num_bases), Xavier-uniform with
    flax's fans. ``forward()`` returns the (num_outputs, *shape) bank."""

    def __init__(self, shape: Sequence[int], num_bases: int,
                 num_outputs: int, *,
                 generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        self.weight = nn.Parameter(flax_init(
            "xavier_uniform", (num_bases,) + tuple(shape), generator))
        self.w_comp = nn.Parameter(flax_init(
            "xavier_uniform", (num_outputs, num_bases), generator))
        self.to(device)

    def forward(self):
        return torch.einsum("ob,b...->o...", self.w_comp, self.weight)


class JumpingKnowledge(nn.Module):
    """Combine per-layer representations (reference ``utils.py:296``):
    ``mode`` ``"cat"`` (along the last dim), ``"max"``, ``"sum"`` or
    ``"mean"`` (over the layers). No parameters; ``in_feats`` and
    ``num_layers`` are kept for the reference's signature, unused there
    too."""

    def __init__(self, mode: str = "cat", in_feats: int = 0,
                 num_layers: int = 0):
        super().__init__()
        if mode not in ("cat", "max", "sum", "mean"):
            raise ValueError(f"Unknown JK mode {mode!r}")
        self.mode = mode

    def forward(self, feat_list):
        if self.mode == "cat":
            return torch.cat(list(feat_list), -1)
        stacked = torch.stack(list(feat_list), 0)
        if self.mode == "max":
            return stacked.max(0).values
        return stacked.sum(0) if self.mode == "sum" else stacked.mean(0)


class LabelPropagation(nn.Module):
    """Iterative label propagation (reference ``utils.py:425``):
    ``Y <- alpha D_in^-1/2 A D_out^-1/2 Y + (1 - alpha) Y0``, ``k`` times,
    clipped to [0, 1] with ``clamp``, rows scaled to sum 1 with
    ``normalize``. ``labels`` are class ids (N,) or a soft (N, C) table;
    ``mask`` keeps the labelled rows of ``Y0``. Each hop is a ``copy_u``
    sum on ``g.local_scope()``, which keeps the graph's plans: on a
    hub-planned graph every hop launches the shell kernel. Degrees below
    1 count as 1. No parameters."""

    def __init__(self, k: int = 3, alpha: float = 0.9, clamp: bool = True,
                 normalize: bool = False):
        super().__init__()
        self.k, self.alpha = k, alpha
        self.clamp, self.normalize = clamp, normalize

    def forward(self, g, labels, mask=None):
        if labels.dim() == 1:
            # the class count is a host read, as the reference's int()
            num_classes = (int(labels.max()) + 1 if labels.numel() else 1)
            y = torch.nn.functional.one_hot(
                labels.to(torch.int64), num_classes).to(torch.float32)
        else:
            y = labels.to(torch.float32)
        if mask is not None:
            y = y * mask.to(y.dtype).unsqueeze(-1)
        init = y
        ni = torch.rsqrt(g.in_degrees().to(y.dtype).clamp_min(1)
                         ).unsqueeze(-1)
        no = torch.rsqrt(g.out_degrees().to(y.dtype).clamp_min(1)
                         ).unsqueeze(-1)
        for _ in range(self.k):
            with g.local_scope() as gg:
                gg.srcdata["h"] = y * no
                gg.update_all(fn.copy_u("h", "m"), fn.sum("m", "h"))
                y = (self.alpha * gg.dstdata["h"] * ni
                     + (1 - self.alpha) * init)
            if self.clamp:
                y = y.clamp(0.0, 1.0)
            if self.normalize:
                y = y / y.sum(-1, keepdim=True).clamp_min(1e-12)
        return y


def pad_edges(x, rel):
    """Per-edge values of the relation's real edges, padded with zero rows
    to its padded edge count: padded edges carry nothing."""
    pad = rel.num_edges_padded - x.shape[0]
    if pad == 0:
        return x
    return torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])


def _clamped(idx, n):
    """Padded edges point at the sink row ``n``: read row ``n - 1`` there,
    as the reference's clamped gathers do."""
    return torch.clamp(idx, max=max(n - 1, 0))
