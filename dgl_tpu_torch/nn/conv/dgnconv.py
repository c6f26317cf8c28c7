"""Directional Graph Network conv (counterpart of
``dgl_tpu/nn/conv/dgnconv.py``; reference
``python/dgl/nn/pytorch/conv/dgnconv.py``): PNA-style aggregators plus
directional ones along the gradient of Laplacian eigenvectors.

A directional aggregator ``dir<k>-av`` or ``dir<k>-dx`` takes column
``k - 1`` of ``eig``: the edge field ``F = eig_u - eig_v`` (a
``u_sub_v`` g-SDDMM), its norm ``sum |F|`` per destination (a ``copy_e``
sum) and the weighted sum ``sum h_u * |F|`` or ``sum h_u * F`` (a
``u_mul_e`` sum), divided by the norm.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ... import function as fn
from ...base import DGLError
from .._init import dense
from .pnaconv import scale_and_project

__all__ = ["DGNConv", "DGNConvTower"]

_REDUCERS = {"mean": fn.mean, "sum": fn.sum, "max": fn.max, "min": fn.min}


class DGNConv(nn.Module):
    """(reference ``dgnconv.py:99``). ``aggregators``: of mean, sum, max,
    min, ``dir<k>-av`` and ``dir<k>-dx``. ``post_fc``: ``nn.Linear(in +
    len(aggregators) * len(scalers) * in, out)``, flax's ``Dense``
    default. ``edge_feat_size`` is kept for the reference's signature
    and unused, as there. ``forward(graph, feat, eig=None,
    edge_feat=None)``."""

    def __init__(self, in_feats: int, out_feats: int,
                 aggregators: Sequence[str] = ("mean", "dir1-av", "dir1-dx"),
                 scalers: Sequence[str] = ("identity",),
                 delta: float = 1.0, dropout: float = 0.0,
                 edge_feat_size: int = 0, residual: bool = True,
                 eps: float = 1e-8, *,
                 generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        self.aggregators, self.scalers = tuple(aggregators), tuple(scalers)
        self.delta, self.eps = delta, eps
        self.residual = residual and in_feats == out_feats
        width = in_feats * (1 + len(self.aggregators) * len(self.scalers))
        self.post_fc = dense(width, out_feats, generator=generator)
        self.dropout = nn.Dropout(dropout)
        self.to(device)

    def forward(self, graph, feat, eig=None, edge_feat=None):
        with graph.local_scope() as g:
            g.srcdata["_h"] = feat
            outs, dir_cache = [], {}
            for agg in self.aggregators:
                if agg.startswith("dir"):
                    if eig is None:
                        raise DGLError("directional aggregators need eig")
                    head, kind = agg.split("-")
                    k = int(head[3:]) - 1
                    if k not in dir_cache:
                        g.srcdata["_eig"] = eig[:, k:k + 1]
                        g.dstdata["_eig"] = eig[:g.num_dst_nodes(), k:k + 1]
                        g.apply_edges(fn.u_sub_v("_eig", "_eig", "_F"))
                        f_e = g.edata["_F"]  # (E, 1)
                        g.edata["_absF"] = torch.abs(f_e)
                        g.update_all(fn.copy_e("_absF", "m"),
                                     fn.sum("m", "_normF"))
                        dir_cache[k] = (f_e, g.dstdata["_normF"])
                    f_e, norm_f = dir_cache[k]
                    g.edata["_w"] = torch.abs(f_e) if kind == "av" else f_e
                    g.update_all(fn.u_mul_e("_h", "_w", "m"),
                                 fn.sum("m", "_o"))
                    outs.append(g.dstdata["_o"] / (norm_f + self.eps))
                elif agg in _REDUCERS:
                    g.update_all(fn.copy_u("_h", "m"),
                                 _REDUCERS[agg]("m", "_o"))
                    outs.append(g.dstdata["_o"])
                else:
                    raise DGLError(f"Unknown DGN aggregator {agg!r}")
            return scale_and_project(g, feat, outs, self.scalers,
                                     self.delta, self.post_fc, self.dropout,
                                     self.residual)


class DGNConvTower(DGNConv):
    """One DGN tower (reference ``dgnconv.py``): :class:`DGNConv` without
    the residual; the reference's wrapped ``DGNConv_0`` parameters land on
    this module's own names."""

    def __init__(self, in_size: int, out_size: int,
                 aggregators: Sequence[str] = ("mean", "dir1-av", "dir1-dx"),
                 scalers: Sequence[str] = ("identity",),
                 delta: float = 1.0, dropout: float = 0.0,
                 edge_feat_size: int = 0, *,
                 generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__(in_size, out_size, aggregators, scalers, delta,
                         dropout, edge_feat_size, residual=False,
                         generator=generator, device=device)
