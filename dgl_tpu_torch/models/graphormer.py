"""Graphormer graph-level model (counterpart of
``dgl_tpu/models/graphormer.py``; reference ``examples/core/Graphormer``
over ``nn/gt``): degree and spatial encodings, ``GraphormerLayer``s over
dense padded batches and the readout at a virtual node.

``prepare_batch`` builds the padded batch on the host: node features,
degrees and the shortest-path distances (``shortest_dist``, scipy's BFS),
slot 0 of each graph being the virtual node."""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch
from torch import nn

from ..graph import _asnumpy
from ..nn._init import dense
from ..nn.gt import DegreeEncoder, GraphormerLayer, SpatialEncoder
from ..transforms.functional import _shortest_dist_host

__all__ = ["Graphormer", "prepare_batch"]


def prepare_batch(graphs: List, feat_key: str = "feat", max_dist: int = 5,
                  *, device=None):
    """The padded batch of ``graphs`` (reference ``prepare_batch``), on
    ``device`` (default: the first graph's): node features (B, N + 1, F)
    float32, in- and out-degrees (B, N + 1, 2) int32, distances
    (B, N + 1, N + 1) int64 clipped to [-1, max_dist] (-1: unreachable or
    padding; the virtual node at 0 from and to its graph's nodes), and the
    attention mask (B, N + 1, N + 1), true where masked."""
    device = graphs[0].device if device is None else torch.device(device)
    B = len(graphs)
    n_max = max(g.num_nodes() for g in graphs) + 1
    F = graphs[0].ndata[feat_key].shape[-1]
    x = np.zeros((B, n_max, F), np.float32)
    deg = np.zeros((B, n_max, 2), np.int32)
    dist = np.full((B, n_max, n_max), -1, np.int64)
    mask = np.zeros((B, n_max, n_max), bool)
    for b, g in enumerate(graphs):
        n = g.num_nodes()
        x[b, 1: n + 1] = _asnumpy(g.ndata[feat_key])
        deg[b, 1: n + 1, 0] = _asnumpy(g.in_degrees())
        deg[b, 1: n + 1, 1] = _asnumpy(g.out_degrees())
        dist[b, 1: n + 1, 1: n + 1] = _shortest_dist_host(g)
        dist[b, 0, : n + 1] = 0
        dist[b, : n + 1, 0] = 0
        mask[b, : n + 1, : n + 1] = True
    return tuple(torch.from_numpy(a).to(device) for a in (
        x, deg, np.clip(dist, -1, max_dist), ~mask))


class Graphormer(nn.Module):
    """(reference Graphormer example model) ``proj_in`` plus
    ``degree_enc`` of the degrees, ``num_layers`` ``GraphormerLayer``s
    (feed-forward width ``2 * hidden_size``) with ``spatial_enc``'s bias,
    and ``head`` on the virtual node. ``forward(x, degrees, dist,
    attn_mask=None)`` takes ``prepare_batch``'s tensors."""

    def __init__(self, feat_size: int, hidden_size: int, num_classes: int,
                 num_layers: int = 4, num_heads: int = 8,
                 max_degree: int = 64, max_dist: int = 5,
                 dropout: float = 0.1, *,
                 generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        self.num_layers = num_layers
        self.proj_in = dense(feat_size, hidden_size, generator=generator)
        self.degree_enc = DegreeEncoder(max_degree, hidden_size,
                                        generator=generator, device=device)
        self.spatial_enc = SpatialEncoder(max_dist, num_heads=num_heads,
                                          generator=generator, device=device)
        for i in range(num_layers):
            self.add_module(f"layer{i}", GraphormerLayer(
                hidden_size, hidden_size * 2, num_heads, dropout=dropout,
                attn_dropout=dropout, generator=generator, device=device))
        self.head = dense(hidden_size, num_classes, generator=generator)
        self.to(device)

    def forward(self, x, degrees, dist, attn_mask=None):
        h = self.proj_in(x) + self.degree_enc(degrees)
        bias = self.spatial_enc(dist)
        for i in range(self.num_layers):
            h = getattr(self, f"layer{i}")(h, bias, attn_mask)
        return self.head(h[:, 0])
