"""GraphSAGE convolution (counterpart of ``dgl_tpu/nn/conv/sageconv.py``).

Reference: ``python/dgl/nn/pytorch/conv/sageconv.py``. Separate self and
neighbour projections; the neighbour projection runs before the message
passing when it narrows the features (``in_feats > out_feats``), so the
aggregation runs at the smaller width. This slice ports the ``mean``
aggregator.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from ... import function as fn
from ...base import DGLError
from .graphconv import expand_as_pair


class SAGEConv(nn.Module):
    """GraphSAGE layer (reference ``sageconv.py:13``).

    Parameters are initialised on the CPU from ``generator`` (Xavier-uniform
    projections, zero bias), as the reference's flax module initialises
    them, and the module is then moved to ``device``.
    """

    def __init__(self, in_feats: int, out_feats: int,
                 aggregator_type: str = "mean", feat_drop: float = 0.0,
                 bias: bool = True, norm: Optional[Callable] = None,
                 activation: Optional[Callable] = None, *,
                 generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        if aggregator_type in ("gcn", "pool", "lstm"):
            raise NotImplementedError(
                f"SAGEConv aggregator {aggregator_type!r}: a later slice "
                "(ROADMAP queue A8)")
        if aggregator_type != "mean":
            raise DGLError(f"Invalid aggregator_type {aggregator_type!r}")
        self.in_feats = in_feats
        self.out_feats = out_feats
        self.aggregator_type = aggregator_type
        self.feat_drop = nn.Dropout(feat_drop)
        self.norm = norm
        self.activation = activation
        self.fc_neigh = nn.Linear(in_feats, out_feats, bias=False)
        self.fc_self = nn.Linear(in_feats, out_feats, bias=False)
        self.bias = nn.Parameter(torch.zeros(out_feats)) if bias else None
        with torch.no_grad():
            nn.init.xavier_uniform_(self.fc_neigh.weight, generator=generator)
            nn.init.xavier_uniform_(self.fc_self.weight, generator=generator)
        self.to(device)

    def forward(self, graph, feat, edge_weight=None):
        with graph.local_scope() as g:
            feat_src, feat_dst = expand_as_pair(feat, g)
            feat_src = self.feat_drop(feat_src)
            feat_dst = self.feat_drop(feat_dst)
            msg_fn = fn.copy_u("h", "m")
            if edge_weight is not None:
                g.edata["_edge_weight"] = edge_weight
                msg_fn = fn.u_mul_e("h", "_edge_weight", "m")
            lin_before_mp = self.in_feats > self.out_feats
            g.srcdata["h"] = (self.fc_neigh(feat_src) if lin_before_mp
                              else feat_src)
            g.update_all(msg_fn, fn.mean("m", "neigh"))
            h_neigh = g.dstdata["neigh"]
            if not lin_before_mp:
                h_neigh = self.fc_neigh(h_neigh)
            rst = self.fc_self(feat_dst) + h_neigh
            if self.bias is not None:
                rst = rst + self.bias
            if self.activation is not None:
                rst = self.activation(rst)
            if self.norm is not None:
                rst = self.norm(rst)
            return rst
