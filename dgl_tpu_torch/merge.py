"""Graph merging (counterpart of ``dgl_tpu/merge.py``; reference
``python/dgl/merge.py:11`` ``dgl.merge``): the union of the edges of graphs
over the same node space."""
from __future__ import annotations

from typing import List

import numpy as np

from .base import DGLError
from .graph import Graph, Relation

__all__ = ["merge"]


def merge(graphs: List[Graph]) -> Graph:
    """Each relation's edges, graph after graph; node counts the largest
    of any graph's; the first graph's node frames. On the first graph's
    device."""
    if not graphs:
        raise DGLError("merge requires at least one graph")
    g0 = graphs[0]
    rels = {}
    for cet in g0.canonical_etypes:
        srcs, dsts = [], []
        for g in graphs:
            src, dst = g._relations[cet].host_edges()
            srcs.append(src)
            dsts.append(dst)
        rels[cet] = Relation.from_coo(
            np.concatenate(srcs),
            np.concatenate(dsts),
            max(g.num_src_nodes(cet[0]) for g in graphs),
            max(g.num_dst_nodes(cet[2]) for g in graphs),
            idtype=g0.idtype, device=g0.device,
        )
    nsrc = {
        nt: max(g.num_nodes(nt) for g in graphs if nt in g.ntypes)
        for nt in g0.ntypes
    }
    out = Graph(rels, nsrc)
    # the first graph's node features (the reference keeps g0's)
    for nt in g0.ntypes:
        out._node_frames[nt] = dict(g0._node_frames.get(nt, {}))
    return out
