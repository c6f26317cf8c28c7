"""GIN layer (counterpart of ``dgl_tpu/nn/conv/ginconv.py``; reference
``python/dgl/nn/pytorch/conv/ginconv.py``): ``(1 + eps) h_v`` plus the
neighbours' ``sum``, ``max`` or ``mean``. The ``sum`` is
``update_all(copy_u, sum)``: on a graph with a hub plan, kernel B1."""
from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from ... import function as fn
from ...base import DGLError
from .graphconv import expand_as_pair

__all__ = ["GINConv"]


class GINConv(nn.Module):
    """Graph Isomorphism Network layer (reference ``ginconv.py:14``).

    ``apply_func`` is any callable; an ``nn.Module`` is registered as the
    child ``apply_func``, as flax names a module handed to the reference.
    ``eps`` is a (1,) parameter with ``learn_eps``.
    ``forward(graph, feat, edge_weight=None)``."""

    def __init__(self, apply_func: Optional[Callable] = None,
                 aggregator_type: str = "sum", init_eps: float = 0.0,
                 learn_eps: bool = False,
                 activation: Optional[Callable] = None, *, device="cuda"):
        super().__init__()
        if aggregator_type not in ("sum", "max", "mean"):
            raise DGLError(f"Invalid aggregator_type {aggregator_type!r}")
        self.apply_func = apply_func
        self.aggregator_type = aggregator_type
        self.activation = activation
        self.eps = (nn.Parameter(torch.full((1,), float(init_eps)))
                    if learn_eps else init_eps)
        self.to(device)

    def forward(self, graph, feat, edge_weight=None):
        reducer = getattr(fn, self.aggregator_type)
        with graph.local_scope() as g:
            feat_src, feat_dst = expand_as_pair(feat, g)
            msg_fn = fn.copy_u("h", "m")
            if edge_weight is not None:
                g.edata["_edge_weight"] = edge_weight
                msg_fn = fn.u_mul_e("h", "_edge_weight", "m")
            g.srcdata["h"] = feat_src
            g.update_all(msg_fn, reducer("m", "neigh"))
            rst = (1 + self.eps) * feat_dst + g.dstdata["neigh"]
            if self.apply_func is not None:
                rst = self.apply_func(rst)
            if self.activation is not None:
                rst = self.activation(rst)
            return rst
