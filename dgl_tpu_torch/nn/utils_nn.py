"""nn utilities (counterpart of ``dgl_tpu/nn/utils_nn.py``; reference
``python/dgl/nn/pytorch/conv/graphconv.py:16``)."""
from __future__ import annotations

import torch
from torch import nn

from .. import ops
from ..base import DGLError

__all__ = ["EdgeWeightNorm", "module_key", "pad_edges"]

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
