"""RelGraphConv, the relational GCN layer (counterpart of
``dgl_tpu/nn/conv/relgraphconv.py``; reference
``python/dgl/nn/pytorch/conv/relgraphconv.py``).

Per-relation weights, optionally a basis decomposition, on a homogeneous
graph whose edges carry a relation id. Each edge's message is its source
row times its relation's weight (``ops.gather_mm``), summed per
destination with ``copy_e`` + ``sum``.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from ... import function as fn
from ...base import DGLError
from ...ops import gather_mm
from .._init import flax_init
from .graphconv import expand_as_pair

__all__ = ["RelGraphConv"]


def _xavier(shape, generator):
    return nn.Parameter(flax_init("xavier_uniform", shape, generator))


class RelGraphConv(nn.Module):
    """R-GCN layer (reference ``relgraphconv.py:14``).

    Parameters as the reference's flax module names and shapes them, so
    :func:`dgl_tpu_torch.params.from_flax_params` carries them:
    ``weight`` (R, in, out), or with ``regularizer="basis"`` ``basis``
    (B, in, out) and ``coeff`` (R, B); ``loop_weight`` (in, out) with
    ``self_loop``; ``h_bias`` (out,) with ``bias``; ``layer_norm`` (flax's
    epsilon 1e-6). Drawn on the CPU from ``generator`` (Xavier-uniform,
    zero bias), then moved to ``device``.

    ``forward(graph, feat, etypes, norm=None)``: ``etypes`` (E,) relation
    ids in edge-id order, ``norm`` an optional (E,) or (E, 1) per-edge
    scale. A padded edge (its source the virtual row ``num_src``) sends no
    message: the reference's clamped gather reads the last row there, and
    its message reaches no real destination either way.
    """

    def __init__(self, in_feats: int, out_feats: int, num_rels: int,
                 regularizer: Optional[str] = None,
                 num_bases: Optional[int] = None, bias: bool = True,
                 activation: Optional[Callable] = None,
                 self_loop: bool = True, dropout: float = 0.0,
                 layer_norm: bool = False, *,
                 generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        if regularizer not in (None, "basis"):
            raise DGLError(f"Unsupported regularizer {regularizer!r}; use "
                           "None or 'basis'")
        self.in_feats, self.out_feats = in_feats, out_feats
        self.num_rels = num_rels
        self.regularizer = regularizer
        self.activation = activation
        self.self_loop = self_loop
        if regularizer == "basis":
            nb = num_bases or num_rels
            self.basis = _xavier((nb, in_feats, out_feats), generator)
            self.coeff = _xavier((num_rels, nb), generator)
        else:
            self.weight = _xavier((num_rels, in_feats, out_feats), generator)
        self.layer_norm = (nn.LayerNorm(out_feats, eps=1e-6) if layer_norm
                           else None)
        self.loop_weight = (_xavier((in_feats, out_feats), generator)
                            if self_loop else None)
        self.h_bias = nn.Parameter(torch.zeros(out_feats)) if bias else None
        self.dropout = nn.Dropout(dropout)
        self.to(device)

    def relation_weights(self) -> torch.Tensor:
        """The (R, in, out) weights: ``coeff @ basis`` with the basis."""
        if self.regularizer == "basis":
            return torch.einsum("rb,bio->rio", self.coeff, self.basis)
        return self.weight

    def forward(self, graph, feat, etypes, norm=None):
        weight = self.relation_weights()
        with graph.local_scope() as g:
            feat_src, feat_dst = expand_as_pair(feat, g)
            rel = g._relation()
            E = rel.num_edges
            h_src_e = feat_src.index_select(0, rel.src[:E])
            m = gather_mm(h_src_e, weight, etypes[:E])
            if norm is not None:
                m = m * norm[:E].reshape((-1,) + (1,) * (m.dim() - 1))
            g.edata["m"] = m
            g.update_all(fn.copy_e("m", "m"), fn.sum("m", "h"))
            rst = g.dstdata["h"]
            if self.layer_norm is not None:
                rst = self.layer_norm(rst)
            if self.loop_weight is not None:
                rst = rst + feat_dst @ self.loop_weight
            if self.h_bias is not None:
                rst = rst + self.h_bias
            if self.activation is not None:
                rst = self.activation(rst)
            return self.dropout(rst)
