"""Principal Neighbourhood Aggregation (counterpart of
``dgl_tpu/nn/conv/pnaconv.py``; reference
``python/dgl/nn/pytorch/conv/pnaconv.py``): several aggregators times
degree scalers, combined by a linear tower.

Every aggregator is a g-SpMM: ``mean`` and ``sum`` a ``copy_u`` reduction
(through a hub plan's kernel where the graph has one), ``var`` and
``std`` two ``copy_u`` means (of ``h`` and ``h * h``), the moments a
``u_sub_v`` g-SDDMM and a ``copy_e`` mean, ``max`` and ``min`` the
extremum reductions.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ... import function as fn
from ...base import DGLError
from .._init import dense

__all__ = ["PNAConv", "PNAConvTower", "scale_and_project"]

_EDGE_REDUCERS = {"mean": fn.mean, "sum": fn.sum, "max": fn.max,
                  "min": fn.min}


def _aggregate(g, h_src, aggregator):
    g.srcdata["_pna_h"] = h_src
    if aggregator in _EDGE_REDUCERS:
        g.update_all(fn.copy_u("_pna_h", "m"),
                     _EDGE_REDUCERS[aggregator]("m", "_pna_out"))
        return g.dstdata["_pna_out"]
    if aggregator in ("var", "std"):
        g.update_all(fn.copy_u("_pna_h", "m"), fn.mean("m", "_mu"))
        g.srcdata["_pna_h2"] = h_src * h_src
        g.update_all(fn.copy_u("_pna_h2", "m"), fn.mean("m", "_mu2"))
        # torch.maximum splits a tie's gradient as jnp.maximum does
        diff = g.dstdata["_mu2"] - g.dstdata["_mu"] ** 2
        var = torch.maximum(diff, torch.zeros_like(diff))
        # as written in the reference: the gradient is about 5e14 where
        # the variance is 0
        return torch.sqrt(var + 1e-30) if aggregator == "std" else var
    if aggregator in ("moment3", "moment4", "moment5"):
        return _moment(g, int(aggregator[-1]))
    raise DGLError(f"Unknown PNA aggregator {aggregator!r}")


def _moment(g, n):
    g.update_all(fn.copy_u("_pna_h", "m"), fn.mean("m", "_mu"))
    g.dstdata["_mu_bcast"] = g.dstdata["_mu"]
    g.apply_edges(fn.u_sub_v("_pna_h", "_mu_bcast", "_diff"))
    g.edata["_diffn"] = g.edata["_diff"] ** n
    g.update_all(fn.copy_e("_diffn", "m"), fn.mean("m", "_mn"))
    mn = g.dstdata["_mn"]
    return torch.sign(mn) * torch.abs(mn + 1e-30) ** (1.0 / n)


def scale_and_project(g, feat, outs, scalers, delta, post_fc, dropout,
                      residual):
    """The towers' common end (reference ``pnaconv.py``/``dgnconv.py``):
    the aggregations ``outs`` concatenated, times each degree scaler
    (in-degrees clamped to 1), concatenated after the destination rows of
    ``feat``, through ``post_fc``, dropout and the optional residual."""
    stacked = torch.cat(outs, -1)
    deg = g.in_degrees().to(stacked.dtype).clamp_min(1).unsqueeze(-1)
    scaled = []
    for s in scalers:
        if s == "identity":
            scaled.append(stacked)
        elif s == "amplification":
            scaled.append(stacked * (torch.log(deg + 1) / delta))
        elif s == "attenuation":
            scaled.append(stacked * (delta / torch.log(deg + 1)))
        else:
            raise DGLError(f"Unknown scaler {s!r}")
    combined = torch.cat(scaled, -1)
    n_dst = combined.shape[0]
    out = dropout(post_fc(torch.cat([feat[:n_dst], combined], -1)))
    if residual:
        out = out + feat[:n_dst]
    return out


class PNAConv(nn.Module):
    """(reference ``pnaconv.py:83``).

    ``post_fc``: ``nn.Linear(in + len(aggregators) * len(scalers) * A,
    out)`` (``A`` the aggregated width, ``in``), drawn as flax's ``Dense``
    default (LeCun-normal, zero bias); with ``edge_feat_size > 0``,
    ``pre_fc`` ``nn.Linear(in + edge_feat_size, in)`` makes each edge's
    message ``leaky_relu(pre_fc(h_u || e))``, and only mean, sum, max and
    min apply. ``num_towers`` is kept for the reference's signature and
    splits nothing, as in the reference. The residual adds the input
    when ``in_feats == out_feats``.
    ``forward(graph, feat, edge_feat=None)``."""

    def __init__(self, in_feats: int, out_feats: int,
                 aggregators: Sequence[str] = ("mean", "max", "min", "std"),
                 scalers: Sequence[str] = ("identity", "amplification",
                                           "attenuation"),
                 delta: float = 1.0, dropout: float = 0.0,
                 num_towers: int = 1, edge_feat_size: int = 0,
                 residual: bool = True, *,
                 generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        self.aggregators, self.scalers = tuple(aggregators), tuple(scalers)
        self.delta = delta
        self.edge_feat_size = edge_feat_size
        self.residual = residual and in_feats == out_feats
        if edge_feat_size > 0:
            self.pre_fc = dense(in_feats + edge_feat_size, in_feats,
                                generator=generator)
        width = in_feats * (1 + len(self.aggregators) * len(self.scalers))
        self.post_fc = dense(width, out_feats, generator=generator)
        self.dropout = nn.Dropout(dropout)
        self.to(device)

    def forward(self, graph, feat, edge_feat=None):
        with graph.local_scope() as g:
            if self.edge_feat_size > 0:
                if edge_feat is None:
                    raise DGLError("edge_feat required when "
                                   "edge_feat_size > 0")
                g.srcdata["_h"] = feat
                g.edata["_e"] = edge_feat
                g.apply_edges(lambda edges: {"m": torch.cat(
                    [edges.src["_h"], edges.data["_e"]], -1)})
                g.edata["_m"] = torch.nn.functional.leaky_relu(
                    self.pre_fc(g.edata["m"]))
                outs = []
                for agg in self.aggregators:
                    red = _EDGE_REDUCERS.get(agg)
                    if red is None:
                        raise DGLError(f"aggregator {agg!r} unsupported "
                                       "with edge features")
                    g.update_all(fn.copy_e("_m", "x"), red("x", f"_o_{agg}"))
                    outs.append(g.dstdata[f"_o_{agg}"])
            else:
                outs = [_aggregate(g, feat, a) for a in self.aggregators]
            return scale_and_project(g, feat, outs, self.scalers,
                                     self.delta, self.post_fc, self.dropout,
                                     self.residual)


class PNAConvTower(PNAConv):
    """One PNA tower (reference ``pnaconv.py:97``): :class:`PNAConv`
    without the residual. The reference wraps a ``PNAConv``; its
    parameters (``PNAConv_0``) land on this module's own names."""

    def __init__(self, in_size: int, out_size: int,
                 aggregators: Sequence[str] = ("mean", "max", "min", "std"),
                 scalers: Sequence[str] = ("identity", "amplification",
                                           "attenuation"),
                 delta: float = 1.0, dropout: float = 0.0,
                 edge_feat_size: int = 0, *,
                 generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__(in_size, out_size, aggregators, scalers, delta,
                         dropout, 1, edge_feat_size, residual=False,
                         generator=generator, device=device)
