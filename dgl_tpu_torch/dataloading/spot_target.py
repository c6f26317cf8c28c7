"""SpotTarget's degree-thresholded edge exclusion (counterpart of
``dgl_tpu/dataloading/spot_target.py``; reference
``python/dgl/dataloading/spot_target.py:7``, arXiv:2306.00899)."""
from __future__ import annotations

import numpy as np

from ..graph import _asnumpy
from .base import find_exclude_eids

__all__ = ["SpotTarget"]


class SpotTarget:
    """An ``exclude`` callable for ``as_edge_prediction_sampler``: a seed
    edge is excluded only when ``min(in_degree(src), in_degree(dst)) <
    degree_threshold``; the survivors are expanded by ``exclude``
    (``"self"``, ``"reverse_id"`` or ``"reverse_types"``)."""

    def __init__(self, g, exclude="self", degree_threshold: int = 10,
                 reverse_eids=None, reverse_etypes=None):
        self.g = g
        self.exclude = exclude
        self.degree_threshold = degree_threshold
        self.reverse_eids = reverse_eids
        self.reverse_etypes = reverse_etypes

    def __call__(self, seed_edges):
        g = self.g
        seed_edges = _asnumpy(seed_edges)
        src, dst = g.find_edges(seed_edges)
        deg = _asnumpy(g.in_degrees())
        degree = np.minimum(deg[_asnumpy(src)], deg[_asnumpy(dst)])
        return find_exclude_eids(
            g, seed_edges[degree < self.degree_threshold], self.exclude,
            self.reverse_eids, self.reverse_etypes)
