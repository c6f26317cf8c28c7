"""Graph-factory layers (counterpart of ``dgl_tpu/nn/factory.py``;
reference ``python/dgl/nn/pytorch/factory.py``): graphs built from point
features, on the points' device (the card for host arrays, unless
``device`` says otherwise)."""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..graph import _asnumpy
from ..transforms.functional import _points, _points_device, knn_graph

__all__ = ["KNNGraph", "SegmentedKNNGraph", "RadiusGraph"]


class KNNGraph(nn.Module):
    """``knn_graph`` of a point set (N, D), or of each of a batch of sets
    (B, N, D), batched into one graph (reference ``factory.py:16``)."""

    def __init__(self, k: int):
        super().__init__()
        self.k = k

    def forward(self, x, algorithm="bruteforce", dist="euclidean", *,
                device=None):
        from ..batch import batch

        x = _points(x, device)
        if x.dim() == 3:
            return batch([knn_graph(x[i], self.k, dist=dist)
                          for i in range(x.shape[0])])
        return knn_graph(x, self.k, dist=dist)


class SegmentedKNNGraph(nn.Module):
    """``knn_graph`` of each segment of ``segs`` points, batched into one
    graph (reference ``factory.py:109``)."""

    def __init__(self, k: int):
        super().__init__()
        self.k = k

    def forward(self, x, segs, dist="euclidean", *, device=None):
        from ..batch import batch

        x = _points(x, device)
        offs = np.concatenate([[0], np.cumsum(_asnumpy(segs))]).astype(
            np.int64)
        return batch([knn_graph(x[lo:hi], self.k, dist=dist)
                      for lo, hi in zip(offs[:-1], offs[1:])])


class RadiusGraph(nn.Module):
    """An edge ``j -> i`` between points within ``r`` in the ``p = 2``
    (else L1) distance, self-loops only with ``self_loop``, in row-major
    order; host numpy in the points' dtype (reference ``factory.py:198``).
    With ``get_distances`` also the (E, 1) distances."""

    def __init__(self, r: float, p: float = 2.0, self_loop: bool = False):
        super().__init__()
        self.r = r
        self.p = p
        self.self_loop = self_loop

    def forward(self, x, get_distances: bool = False, *, device=None):
        from .. import convert

        device = _points_device(x, device)
        x = _asnumpy(x)
        if self.p == 2:
            d = np.sqrt(((x[:, None, :] - x[None, :, :]) ** 2).sum(-1))
        else:
            d = np.abs(x[:, None, :] - x[None, :, :]).sum(-1)
        mask = d <= self.r
        if not self.self_loop:
            np.fill_diagonal(mask, False)
        src, dst = np.nonzero(mask)
        g = convert.graph((src, dst), num_nodes=x.shape[0], device=device)
        if get_distances:
            return g, torch.from_numpy(np.ascontiguousarray(
                d[src, dst][:, None])).to(device)
        return g
