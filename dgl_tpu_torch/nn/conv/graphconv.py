"""Helpers of the GraphConv module (counterpart of
``dgl_tpu/nn/conv/graphconv.py``); the GraphConv layer itself comes with
the full-graph GCN slice (ROADMAP queue A7)."""
from __future__ import annotations


def expand_as_pair(feat, graph=None):
    """Split a feature into (src, dst) like the reference's helper."""
    if isinstance(feat, tuple):
        return feat
    if graph is not None and graph.is_block:
        return feat, feat[: graph.num_dst_nodes()]
    return feat, feat
