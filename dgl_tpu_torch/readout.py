"""Graph-level readout over (batched) graphs (counterpart of
``dgl_tpu/readout.py``; reference ``python/dgl/readout.py:26-775``).

Each op reduces node or edge features graph by graph, with
``batch_num_nodes``/``batch_num_edges`` as segment lengths, through the
segment ops of ``ops/segment.py``. A padded graph's extra edge rows fall in
the last graph's segment, as in the reference.
"""
from __future__ import annotations

import torch

from .base import DGLError
from .graph import Graph
from .ops.segment import _seg_ids, segment_reduce, segment_softmax

__all__ = [
    "readout_nodes",
    "readout_edges",
    "sum_nodes",
    "mean_nodes",
    "max_nodes",
    "sum_edges",
    "mean_edges",
    "max_edges",
    "softmax_nodes",
    "softmax_edges",
    "broadcast_nodes",
    "broadcast_edges",
    "topk_nodes",
    "topk_edges",
]


def _node_feat(g: Graph, feat, ntype):
    nt = ntype or (g.ntypes[0] if len(g.ntypes) == 1 else None)
    if nt is None:
        raise DGLError("ntype required for heterogeneous graphs")
    return g._node_frames[nt][feat], g.batch_num_nodes(nt)


def _edge_feat(g: Graph, feat, etype):
    cet = g.to_canonical_etype(etype)
    return g._edge_frames[cet][feat], g.batch_num_edges(cet)


def _weighted(x, g, weight, kind, type_name):
    if weight is None:
        return x
    w = (_node_feat if kind == "node" else _edge_feat)(g, weight,
                                                       type_name)[0]
    while w.dim() < x.dim():
        w = w[..., None]
    return x * w


def readout_nodes(g: Graph, feat, weight=None, op="sum", ntype=None):
    """Per-graph node readout (reference ``readout.py:26``): ``op`` in
    {sum, mean, max, min}, features optionally weighted by ``weight``."""
    x, seglen = _node_feat(g, feat, ntype)
    return segment_reduce(seglen, _weighted(x, g, weight, "node", ntype), op)


def readout_edges(g: Graph, feat, weight=None, op="sum", etype=None):
    """Per-graph edge readout (reference ``readout.py:163``)."""
    x, seglen = _edge_feat(g, feat, etype)
    return segment_reduce(seglen, _weighted(x, g, weight, "edge", etype), op)


def sum_nodes(g, feat, weight=None, ntype=None):
    return readout_nodes(g, feat, weight, "sum", ntype)


def mean_nodes(g, feat, weight=None, ntype=None):
    return readout_nodes(g, feat, weight, "mean", ntype)


def max_nodes(g, feat, weight=None, ntype=None):
    return readout_nodes(g, feat, weight, "max", ntype)


def sum_edges(g, feat, weight=None, etype=None):
    return readout_edges(g, feat, weight, "sum", etype)


def mean_edges(g, feat, weight=None, etype=None):
    return readout_edges(g, feat, weight, "mean", etype)


def max_edges(g, feat, weight=None, etype=None):
    return readout_edges(g, feat, weight, "max", etype)


def softmax_nodes(g, feat, ntype=None):
    """Softmax over each graph's nodes (reference ``readout.py:392``)."""
    x, seglen = _node_feat(g, feat, ntype)
    return segment_softmax(seglen, x)


def softmax_edges(g, feat, etype=None):
    x, seglen = _edge_feat(g, feat, etype)
    return segment_softmax(seglen, x)


def broadcast_nodes(g: Graph, graph_feat, ntype=None):
    """Each graph's feature copied to its nodes (reference
    ``readout.py:493``)."""
    nt = ntype or (g.ntypes[0] if len(g.ntypes) == 1 else None)
    return graph_feat[_seg_ids(g.batch_num_nodes(nt), g.num_nodes(nt))]


def broadcast_edges(g: Graph, graph_feat, etype=None):
    """Each graph's feature copied to its edges, padded ones included."""
    cet = g.to_canonical_etype(etype)
    total = g._relations[cet].num_edges_padded
    return graph_feat[_seg_ids(g.batch_num_edges(cet), total)]


def _topk(x, seglen, k, descending, sortby):
    """Per-segment top-k: a (B, max(len, k)) table of keys, short segments
    padded with -inf (+inf ascending), sorted stably; the padded slots give
    row 0's values, as in the reference."""
    n = seglen.shape[0]
    total = x.shape[0]
    ids = _seg_ids(seglen, total)
    key = x if sortby is None else x[..., sortby]
    if key.dim() > 1:
        raise DGLError("topk with sortby expects 2D features")
    fill = -torch.inf if descending else torch.inf
    maxlen = max(int(seglen.max()) if total else 0, k)
    starts = torch.cumsum(seglen, 0) - seglen
    pos = torch.arange(total, device=x.device) - starts[ids]
    # rows past the lengths' sum (a padded graph's) land beyond the last
    # segment's end; the reference's scatter drops them
    keep = pos < maxlen
    dense = key.new_full((n, maxlen), fill)
    dense[ids[keep], pos[keep]] = key[keep]
    denseidx = torch.zeros((n, maxlen), dtype=torch.int64, device=x.device)
    denseidx[ids[keep], pos[keep]] = torch.arange(total,
                                                  device=x.device)[keep]
    order = torch.argsort(-dense if descending else dense, dim=1,
                          stable=True)[:, :k]
    sel = torch.gather(denseidx, 1, order)
    return x[sel], sel


def topk_nodes(g: Graph, feat, k, descending=True, sortby=None, ntype=None):
    """Each graph's top-k nodes by feature (reference ``readout.py:560``):
    the values (B, k, ...) and their node ids (B, k)."""
    x, seglen = _node_feat(g, feat, ntype)
    return _topk(x, seglen, k, descending, sortby)


def topk_edges(g: Graph, feat, k, descending=True, sortby=None, etype=None):
    x, seglen = _edge_feat(g, feat, etype)
    return _topk(x, seglen, k, descending, sortby)
