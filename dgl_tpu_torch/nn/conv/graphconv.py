"""GraphConv, the GCN layer (counterpart of ``dgl_tpu/nn/conv/graphconv.py``).

Reference: ``python/dgl/nn/pytorch/conv/graphconv.py:157`` (class) and
``:419-457`` (forward): symmetric degree normalisation, the weight applied
on the smaller side of the aggregation, ``update_all(copy_u, sum)``
lowering to g-SpMM (the bitmap or hub plan where the graph carries one).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from ... import function as fn
from ...base import DGLError

_NORMS = ("none", "both", "right", "left")


def expand_as_pair(feat, graph=None):
    """Split a feature into (src, dst) like the reference's helper."""
    if isinstance(feat, tuple):
        return feat
    if graph is not None and graph.is_block:
        return feat, feat[: graph.num_dst_nodes()]
    return feat, feat


def check_zero_in_degree(graph, allow: bool):
    """Raise when a destination node has no in-edge (its output would be
    invalid), unless ``allow``. Reads the relation's minimum in-degree,
    counted on the host when it was built: no device read, no sync. A
    relation built without it (-1, not known) reads its degrees instead."""
    if allow or graph.num_dst_nodes() == 0:
        return
    rel = graph._relation()
    low = rel.min_in_degree
    if low < 0:
        low = int(rel.in_degrees().min())
    if low == 0:
        raise DGLError(
            "There are 0-in-degree nodes in the graph; output for those "
            "nodes will be invalid. Add self-loops or pass "
            "allow_zero_in_degree=True (reference graphconv.py:440 check).")


def _norm(degs, kind, like):
    """The degree normaliser: ``1 / sqrt(deg)`` for "both" (as the
    reference's ``jax_rsqrt`` computes it, not ``torch.rsqrt``), else
    ``1 / deg``; degrees clamped at 1, broadcast over ``like``'s feature
    dims."""
    degs = torch.clamp(degs.to(like.dtype), min=1)
    nrm = 1.0 / torch.sqrt(degs) if kind == "both" else 1.0 / degs
    return nrm.reshape(nrm.shape + (1,) * (like.dim() - 1))


def _aggregate(g, feat_src, edge_weight):
    msg_fn = fn.copy_u("h", "m")
    if edge_weight is not None:
        g.edata["_edge_weight"] = edge_weight
        msg_fn = fn.u_mul_e("h", "_edge_weight", "m")
    g.srcdata["h"] = feat_src
    g.update_all(msg_fn, fn.sum("m", "h"))
    return g.dstdata["h"]


def precompute_graphconv(graph, feat, norm: str = "both", edge_weight=None,
                         hops: int = 1):
    """The (normalised) GraphConv aggregation of a static input, ``hops``
    times (reference ``graphconv.py:50``).

    ``GraphConv(g, x)`` equals the layer's weight and bias applied to
    ``precompute_graphconv(g, x, norm)`` because message + sum is linear:
    ``Â (X W) = (Â X) W``. Use with ``GraphConv(..., precomputed=True)`` or
    ``GCN(static_input_agg=True)``."""
    if norm not in _NORMS:
        raise DGLError(f"Invalid norm value {norm!r}")
    with graph.local_scope() as g:
        for _ in range(hops):
            feat_src, _ = expand_as_pair(feat, g)
            if norm in ("left", "both"):
                feat_src = feat_src * _norm(g.out_degrees(), norm, feat_src)
            rst = _aggregate(g, feat_src, edge_weight)
            if norm in ("right", "both"):
                rst = rst * _norm(g.in_degrees(), norm, rst)
            feat = rst
        return feat


class GraphConv(nn.Module):
    """GCN convolution (Kipf & Welling), reference ``graphconv.py:157``.

    ``weight`` is an (in_feats, out_feats) parameter, as in the reference's
    flax module, so :func:`dgl_tpu_torch.params.from_flax_params` carries it
    as it is. Parameters are drawn on the CPU from ``generator``
    (Xavier-uniform weight, zero bias) and the module is then moved to
    ``device``. ``forward(..., precomputed=True)`` declares ``feat`` to be
    the aggregate of :func:`precompute_graphconv`: the layer then applies
    only its weight and bias.
    """

    def __init__(self, in_feats: int, out_feats: int, norm: str = "both",
                 weight: bool = True, bias: bool = True,
                 activation: Optional[Callable] = None,
                 allow_zero_in_degree: bool = False, *,
                 generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        if norm not in _NORMS:
            raise DGLError(f"Invalid norm value {norm!r}")
        self.in_feats = in_feats
        self.out_feats = out_feats
        self.norm = norm
        self.activation = activation
        self.allow_zero_in_degree = allow_zero_in_degree
        if weight:
            self.weight = nn.Parameter(torch.empty(in_feats, out_feats))
            with torch.no_grad():
                nn.init.xavier_uniform_(self.weight, generator=generator)
        else:
            self.weight = None
        self.bias = nn.Parameter(torch.zeros(out_feats)) if bias else None
        self.to(device)

    def _apply_params(self, rst):
        if self.bias is not None:
            rst = rst + self.bias
        if self.activation is not None:
            rst = self.activation(rst)
        return rst

    def forward(self, graph, feat, edge_weight=None, precomputed=False):
        if precomputed:
            rst = feat @ self.weight if self.weight is not None else feat
            return self._apply_params(rst)
        check_zero_in_degree(graph, self.allow_zero_in_degree)
        with graph.local_scope() as g:
            feat_src, _ = expand_as_pair(feat, g)
            if self.norm in ("left", "both"):
                feat_src = feat_src * _norm(g.out_degrees(), self.norm,
                                            feat_src)
            if self.in_feats > self.out_feats:
                # project first so the aggregation runs at the smaller width
                if self.weight is not None:
                    feat_src = feat_src @ self.weight
                rst = _aggregate(g, feat_src, edge_weight)
            else:
                rst = _aggregate(g, feat_src, edge_weight)
                if self.weight is not None:
                    rst = rst @ self.weight
            if self.norm in ("right", "both"):
                rst = rst * _norm(g.in_degrees(), self.norm, rst)
            return self._apply_params(rst)
