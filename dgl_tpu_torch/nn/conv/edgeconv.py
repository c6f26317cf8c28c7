"""EdgeConv of Dynamic Graph CNN (counterpart of
``dgl_tpu/nn/conv/edgeconv.py``; reference
``python/dgl/nn/pytorch/conv/edgeconv.py``): the message
``theta(x_u - x_v) + phi(x_v)``, reduced by ``max`` over ``copy_e``."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ... import function as fn
from ...ops.sddmm import _gather_target
from .._init import dense
from .graphconv import expand_as_pair

__all__ = ["EdgeConv"]


class EdgeConv(nn.Module):
    """(reference ``edgeconv.py:12``). ``theta`` and ``phi``:
    ``nn.Linear`` with bias, Xavier-uniform. With ``batch_norm``, ``bn``
    normalises the messages with its running statistics in training too,
    as the reference's ``BatchNorm(use_running_average=True)`` does
    (flax's epsilon 1e-5)."""

    def __init__(self, in_feats: int, out_feats: int,
                 batch_norm: bool = False, *,
                 generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        self.theta = dense(in_feats, out_feats, True, "xavier_uniform",
                           generator)
        self.phi = dense(in_feats, out_feats, True, "xavier_uniform",
                         generator)
        self.bn = nn.BatchNorm1d(out_feats, eps=1e-5) if batch_norm else None
        self.to(device)

    def forward(self, graph, feat):
        with graph.local_scope() as g:
            h_src, h_dst = expand_as_pair(feat, g)
            g.srcdata["x"] = h_src
            g.dstdata["x"] = h_dst
            g.apply_edges(fn.u_sub_v("x", "x", "theta"))
            # phi(x_v) per edge, gathered as the reference's (clamped on
            # padded edges, whose messages the max drops)
            e = self.theta(g.edata["theta"]) + _gather_target(
                g._relation(), "v", self.phi(h_dst))
            if self.bn is not None:
                bn = self.bn
                e = torch.nn.functional.batch_norm(
                    e, bn.running_mean, bn.running_var, bn.weight, bn.bias,
                    training=False, eps=bn.eps)
            g.edata["e"] = e
            g.update_all(fn.copy_e("e", "m"), fn.max("m", "x"))
            return g.dstdata["x"]
