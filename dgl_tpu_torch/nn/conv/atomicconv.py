"""Atomic convolution (counterpart of ``dgl_tpu/nn/conv/atomicconv.py``;
reference ``python/dgl/nn/pytorch/conv/atomicconv.py``, ACNN): radial
basis filters of the interatomic distances with a smooth cutoff, summed
per destination atom (a ``copy_e`` g-SpMM), per neighbour atom type when
``features_to_use`` is given (the per-edge type-by-filter outer product,
an edge UDF, then the sum)."""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from ... import function as fn

__all__ = ["AtomicConv", "RadialPooling", "msg_func", "reduce_func"]


class AtomicConv(nn.Module):
    """(reference ``atomicconv.py:57``). No parameters.

    ``forward(graph, feat, distances)``: ``feat`` (N, 1) atomic numbers,
    ``distances`` (E, 1). Output (N, K), or (N, T * K) with
    ``features_to_use`` of T atom types: per radial filter (and per
    neighbour type) the summed responses
    ``exp(-gamma (d - mu)^2) * 0.5 (cos(pi d / rc) + 1)`` (0 past the
    cutoff ``rc``)."""

    def __init__(self, interaction_cutoffs: Sequence[float],
                 rbf_kernel_means: Sequence[float],
                 rbf_kernel_scaling: Sequence[float],
                 features_to_use: Optional[Sequence[float]] = None):
        super().__init__()
        self.cutoffs = tuple(map(float, interaction_cutoffs))
        self.means = tuple(map(float, rbf_kernel_means))
        self.scales = tuple(map(float, rbf_kernel_scaling))
        self.features_to_use = (None if features_to_use is None
                                else tuple(map(float, features_to_use)))

    def forward(self, graph, feat, distances):
        d = distances.reshape(-1, 1).to(torch.float32)
        put = lambda v: torch.tensor(v, dtype=torch.float32,  # noqa: E731
                                     device=d.device).unsqueeze(0)
        cutoffs, means, scales = (put(self.cutoffs), put(self.means),
                                  put(self.scales))
        rbf = torch.exp(-scales * (d - means) ** 2)  # (E, K)
        fc = torch.where(d < cutoffs,
                         0.5 * (torch.cos(math.pi * d / cutoffs) + 1.0),
                         torch.zeros((), device=d.device))
        e = rbf * fc
        with graph.local_scope() as g:
            g.edata["e"] = e
            if self.features_to_use is not None:
                types = put(self.features_to_use)
                g.srcdata["t"] = (feat.reshape(-1, 1) == types).to(
                    torch.float32)  # (N, T)
                g.apply_edges(lambda edges: {
                    "m": edges.src["t"].unsqueeze(2)
                    * edges.data["e"].unsqueeze(1)})
                g.update_all(fn.copy_e("m", "x"), fn.sum("x", "out"))
                out = g.dstdata["out"]  # (N, T, K)
                return out.reshape(out.shape[0], -1)
            g.update_all(fn.copy_e("e", "x"), fn.sum("x", "out"))
            return g.dstdata["out"]


class RadialPooling(nn.Module):
    """Radial-basis pooling over interatomic distances (reference
    ``atomicconv.py:8``): ``exp(-gamma (d - mu)^2)``, 0 from the cutoff
    ``rc`` on. ``forward(distances)`` (E, 1) gives (K, E, 1)."""

    def __init__(self, interaction_cutoffs, rbf_kernel_means,
                 rbf_kernel_scaling):
        super().__init__()
        self.cutoffs = torch.as_tensor(interaction_cutoffs,
                                       dtype=torch.float32)
        self.means = torch.as_tensor(rbf_kernel_means, dtype=torch.float32)
        self.scales = torch.as_tensor(rbf_kernel_scaling,
                                      dtype=torch.float32)

    def forward(self, distances):
        d = distances.unsqueeze(0)
        mu, gamma, rc = (t.to(d.device).reshape(-1, 1, 1)
                         for t in (self.means, self.scales, self.cutoffs))
        rbf = torch.exp(-gamma * (d - mu) ** 2)
        return rbf * (d < rc).to(rbf.dtype)


def msg_func(edges):
    """Message: distance-weighted source features (reference
    ``atomicconv.py:100``)."""
    return {"m": edges.src["hv"] * edges.data["he"]}


def reduce_func(nodes):
    """Reduce: the sum of the radial messages over the padded mailbox,
    whose padding slots hold zeros (reference ``atomicconv.py:126``)."""
    return {"hv_new": nodes.mailbox["m"].sum(1)}
