"""NNConv, the edge-network convolution of MPNN (counterpart of
``dgl_tpu/nn/conv/nnconv.py``; reference
``python/dgl/nn/pytorch/conv/nnconv.py``): each edge's message is its
source row times an (in, out) matrix that ``edge_func`` makes from the
edge's features, reduced by ``sum``, ``mean`` or ``max`` over
``copy_e``."""
from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from ... import function as fn
from ...base import DGLError
from ...ops.sddmm import _gather_target
from .._init import dense
from .graphconv import expand_as_pair

__all__ = ["NNConv"]


class NNConv(nn.Module):
    """(reference ``nnconv.py:13``). ``edge_func`` maps (E, edge_feats) to
    (E, in_feats * out_feats); an ``nn.Module`` is registered as the child
    ``edge_func``. ``res_fc`` (with ``residual``) is an ``nn.Linear``
    without bias, Xavier-uniform; ``bias`` (out,) zeros.
    ``forward(graph, feat, efeat)``."""

    def __init__(self, in_feats: int, out_feats: int,
                 edge_func: Callable = None, aggregator_type: str = "mean",
                 residual: bool = False, bias: bool = True, *,
                 generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        if aggregator_type not in ("sum", "mean", "max"):
            raise DGLError(f"Invalid aggregator {aggregator_type!r}")
        self.in_feats, self.out_feats = in_feats, out_feats
        self.edge_func = edge_func
        self.aggregator_type = aggregator_type
        self.res_fc = (dense(in_feats, out_feats, False, "xavier_uniform",
                             generator) if residual else None)
        self.bias = nn.Parameter(torch.zeros(out_feats)) if bias else None
        self.to(device)

    def forward(self, graph, feat, efeat):
        with graph.local_scope() as g:
            feat_src, feat_dst = expand_as_pair(feat, g)
            ew = self.edge_func(efeat).reshape(-1, self.in_feats,
                                               self.out_feats)
            # the source rows as the reference gathers them (clamped on
            # padded edges, whose messages no reducer reads)
            h_u = _gather_target(g._relation(), "u", feat_src)
            g.edata["m"] = torch.bmm(h_u.unsqueeze(1), ew).squeeze(1)
            g.update_all(fn.copy_e("m", "m"),
                         getattr(fn, self.aggregator_type)("m", "neigh"))
            rst = g.dstdata["neigh"]
            if self.res_fc is not None:
                rst = rst + self.res_fc(feat_dst)
            if self.bias is not None:
                rst = rst + self.bias
            return rst
