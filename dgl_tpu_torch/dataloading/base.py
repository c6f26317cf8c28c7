"""Sampler bases and the edge-prediction wrapper (counterpart of
``dgl_tpu/dataloading/base.py``; reference ``python/dgl/dataloading/
base.py:162-500``)."""
from __future__ import annotations

import numpy as np

from ..base import NID, DGLError
from ..graph import _asnumpy

__all__ = ["Sampler", "BlockSampler", "find_exclude_eids",
           "as_edge_prediction_sampler", "EdgePredictionSampler"]


class Sampler:
    """Abstract sampler: ``sample(g, indices) -> minibatch`` (reference
    ``dataloading/base.py:162``)."""

    def sample(self, g, indices):
        raise NotImplementedError


class BlockSampler(Sampler):
    """Base of the samplers that produce lists of MFG blocks (reference
    ``dataloading/base.py:195``): subclasses implement
    ``sample_blocks(g, seed_nodes, exclude_eids=None) -> (input_nodes,
    output_nodes, blocks)``."""

    def __init__(self, prefetch_node_feats=None, prefetch_labels=None,
                 prefetch_edge_feats=None, output_device=None):
        self.prefetch_node_feats = prefetch_node_feats or []
        self.prefetch_labels = prefetch_labels or []
        self.prefetch_edge_feats = prefetch_edge_feats or []
        self.output_device = output_device

    def sample_blocks(self, g, seed_nodes, exclude_eids=None):
        raise NotImplementedError

    def sample(self, g, seed_nodes, exclude_eids=None):
        return self.sample_blocks(g, seed_nodes, exclude_eids=exclude_eids)


def find_exclude_eids(g, seed_edges, exclude, reverse_eids=None,
                      reverse_etypes=None):
    """The edge ids to leave out of a batch's sampled neighbourhoods
    (reference ``dataloading/base.py:286``): ``exclude`` is None,
    ``"self"`` (the seed edges), ``"reverse_id"`` (and
    ``reverse_eids[seed_edges]``), ``"reverse_types"`` (a dict by
    canonical edge type, the same ids under ``reverse_etypes[etype]``),
    or a callable of the seed edges. Host int64 arrays."""
    if not isinstance(seed_edges, dict):
        seed_edges = _asnumpy(seed_edges)
    if exclude is None:
        return None
    if exclude == "self":
        return seed_edges
    if exclude == "reverse_id":
        if reverse_eids is None:
            raise DGLError("reverse_eids required for exclude='reverse_id'")
        return np.concatenate([seed_edges,
                               _asnumpy(reverse_eids)[seed_edges]])
    if exclude == "reverse_types":
        if reverse_etypes is None:
            raise DGLError(
                "reverse_etypes required for exclude='reverse_types'")
        if not isinstance(seed_edges, dict):
            if len(g.canonical_etypes) != 1:
                raise DGLError("hetero graphs need {etype: eids} seeds")
            seed_edges = {g.canonical_etypes[0][1]: seed_edges}
        out = {}
        for et, eids in seed_edges.items():
            cet = g.to_canonical_etype(et)
            eids = _asnumpy(eids)
            out[cet] = np.concatenate([out.get(cet, eids[:0]), eids])
            rev = reverse_etypes.get(et, reverse_etypes.get(cet))
            if rev is not None:
                rcet = g.to_canonical_etype(rev)
                out[rcet] = np.concatenate([out.get(rcet, eids[:0]), eids])
        return out
    if callable(exclude):
        res = exclude(seed_edges)
        return res if isinstance(res, dict) else _asnumpy(res)
    raise DGLError(f"Unknown exclude mode {exclude!r}")


class EdgePredictionSampler(Sampler):
    """A node sampler wrapped for edge prediction (reference
    ``dataloading/base.py:500``). ``sample(g, seed_edges)`` returns
    ``(input_nodes, pair_graph, [negative_pair_graph,] blocks)``: the
    seed edges' (and the negative pairs') endpoints, compacted alike,
    are the seeds of the wrapped sampler, which leaves the excluded edges
    out of its blocks."""

    def __init__(self, sampler, exclude=None, reverse_eids=None,
                 reverse_etypes=None, negative_sampler=None):
        self.sampler = sampler
        self.exclude = exclude
        self.reverse_eids = reverse_eids
        self.reverse_etypes = reverse_etypes
        self.negative_sampler = negative_sampler

    def sample(self, g, seed_edges):
        from ..convert import graph
        from ..subgraph import edge_subgraph
        from ..transforms.functional import compact_graphs

        seed_edges = _asnumpy(seed_edges)
        pair_graph = edge_subgraph(g, seed_edges, relabel_nodes=False)
        exclude_eids = find_exclude_eids(
            g, seed_edges, self.exclude, self.reverse_eids,
            self.reverse_etypes)
        neg_graph = None
        if self.negative_sampler is not None:
            neg_src, neg_dst = self.negative_sampler(g, seed_edges)
            neg_graph = graph((_asnumpy(neg_src), _asnumpy(neg_dst)),
                              num_nodes=g.num_nodes(), device=g.device)
            pair_graph, neg_graph = compact_graphs([pair_graph, neg_graph])
        else:
            pair_graph = compact_graphs(pair_graph)
        seed_nodes = _asnumpy(pair_graph.ndata[NID])
        input_nodes, _, blocks = self.sampler.sample_blocks(
            g, seed_nodes, exclude_eids=exclude_eids)
        if neg_graph is not None:
            return input_nodes, pair_graph, neg_graph, blocks
        return input_nodes, pair_graph, blocks


def as_edge_prediction_sampler(sampler, exclude=None, reverse_eids=None,
                               reverse_etypes=None, negative_sampler=None):
    """(reference ``dataloading/base.py:500``)."""
    return EdgePredictionSampler(sampler, exclude, reverse_eids,
                                 reverse_etypes, negative_sampler)
