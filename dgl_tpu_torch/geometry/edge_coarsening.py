"""Neighbour matching for edge coarsening (counterpart of
``dgl_tpu/geometry/edge_coarsening.py``; reference
``python/dgl/geometry/edge_coarsening.py:9``, C++ ``src/geometry/``)."""
from __future__ import annotations

import numpy as np

from ..graph import _asnumpy

__all__ = ["neighbor_matching"]


def neighbor_matching(graph, e_weights=None, relabel_idx: bool = True):
    """Greedy maximal matching for graclus pooling: edges in order of
    falling weight (``np.argsort(-w)``, the reference's call) or of id,
    each joining its two endpoints if both are free; a matched pair takes
    the first endpoint's id, an unmatched node its own. With
    ``relabel_idx`` the cluster ids are made consecutive. Host numpy, one
    sequential pass as in the reference; int64 on the graph's device."""
    import torch

    rel = graph._relation(None)
    n = graph.num_nodes()
    src, dst = rel.host_edges()
    order = (np.argsort(-_asnumpy(e_weights)) if e_weights is not None
             else np.arange(src.shape[0]))
    matched = np.full(n, -1, dtype=np.int64)
    for e in order:
        u, v = int(src[e]), int(dst[e])
        if u == v or matched[u] >= 0 or matched[v] >= 0:
            continue
        matched[u] = u
        matched[v] = u
    unmatched = matched < 0
    matched[unmatched] = np.nonzero(unmatched)[0]
    if relabel_idx:
        matched = np.unique(matched, return_inverse=True)[1].reshape(-1)
    return torch.from_numpy(matched.astype(np.int64)).to(graph.device)
