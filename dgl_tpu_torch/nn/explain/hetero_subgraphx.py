"""HeteroSubgraphX (counterpart of
``dgl_tpu/nn/explain/hetero_subgraphx.py``; reference
``python/dgl/nn/pytorch/explain/heterosubgraphx.py``): ``SubgraphX``'s
tree search over heterographs.

A node is addressed by a global id, its type's offset (``graph.ntypes``
order) plus its id in the type; pruning a node zeroes its feature row.
``model_fn(graph, feat_dict) -> logits``.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from .subgraphx import MCTSNode, _prune, _search

__all__ = ["HeteroSubgraphX"]


def _owner(offs, g, gid):
    """The node type of global id ``gid``: the last type, in
    ``g.ntypes`` order, whose offset is at most ``gid``."""
    owner = None
    for nt in g.ntypes:
        if gid >= offs[nt]:
            owner = nt
        else:
            break
    return owner


class HeteroSubgraphX:
    """(reference ``heterosubgraphx.py:10``)."""

    def __init__(self, model_fn: Callable, num_hops: int = 2,
                 coef: float = 10.0, high2low: bool = True,
                 num_rollouts: int = 20, node_min: int = 3,
                 shapley_steps: int = 20, seed: int = 0):
        self.model_fn = model_fn
        self.coef = coef
        self.high2low = high2low
        self.num_rollouts = num_rollouts
        self.node_min = node_min
        self.shapley_steps = shapley_steps
        self._rng = np.random.default_rng(seed)

    def _index(self, g):
        """Per-type offsets, the node count, and each global id's
        neighbours over every edge type, both directions."""
        offs, base = {}, 0
        for nt in g.ntypes:
            offs[nt] = base
            base += g.num_nodes(nt)
        adj = [[] for _ in range(base)]
        for cet in g.canonical_etypes:
            st, _, dt = cet
            src, dst = g._relations[cet].host_edges()
            for gu, gv in zip((src + offs[st]).tolist(),
                              (dst + offs[dt]).tolist()):
                adj[gu].append(gv)
                adj[gv].append(gu)
        return offs, base, adj

    @torch.no_grad()
    def _masked_logit(self, g, feat: Dict, keep, offs, target):
        masked = {}
        for nt, x in feat.items():
            m = np.zeros(x.shape[0], np.float32)
            for gid in keep:
                lid = gid - offs[nt]
                if 0 <= lid < x.shape[0] and _owner(offs, g, gid) == nt:
                    m[lid] = 1.0
            masked[nt] = x * torch.from_numpy(m).to(x.device)[:, None]
        out = torch.atleast_2d(self.model_fn(g, masked))
        return float(out[0, target])

    def _shapley(self, g, feat, subset, offs, adj, target):
        sub = set(subset)
        nbrs = set()
        for u in sub:
            nbrs.update(adj[u])
        region = sorted(nbrs - sub)
        total = 0.0
        for _ in range(self.shapley_steps):
            coal = [x for x in region if self._rng.random() < 0.5]
            with_s = self._masked_logit(g, feat, sub | set(coal), offs, target)
            without = self._masked_logit(g, feat, set(coal), offs, target)
            total += with_s - without
        return total / self.shapley_steps

    def explain_graph(self, graph, feat: Dict, target: Optional[int] = None,
                      node_max: int = 8):
        """Returns ({ntype: kept local ids}, score) (reference
        ``heterosubgraphx.py:132``)."""
        offs, total_nodes, adj = self._index(graph)
        if target is None:
            with torch.no_grad():
                out = torch.atleast_2d(self.model_fn(graph, feat))
            target = int(torch.argmax(out[0]))
        deg = np.array([len(a) for a in adj])
        best_nodes, best_score = _search(
            MCTSNode(frozenset(range(total_nodes))), self.num_rollouts,
            node_max, self.node_min, self.coef,
            lambda nodes: self._shapley(graph, feat, nodes, offs, adj,
                                        target),
            lambda nodes: _prune(nodes, deg, self.high2low))
        result: Dict[str, np.ndarray] = {}
        for nt in graph.ntypes:
            lo = offs[nt]
            hi = lo + graph.num_nodes(nt)
            ids = sorted(v - lo for v in best_nodes if lo <= v < hi)
            if ids:
                result[nt] = np.array(ids)
        return result, best_score
