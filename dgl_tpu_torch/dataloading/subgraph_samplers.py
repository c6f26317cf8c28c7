"""Subgraph minibatch samplers (counterpart of
``dgl_tpu/dataloading/subgraph_samplers.py``; reference
``python/dgl/dataloading/cluster_gcn.py``, ``saint.py``, ``shadow.py``).
The subgraphs lie on the graph's device."""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..base import DGLError
from ..graph import _asnumpy
from .base import Sampler

__all__ = ["ClusterGCNSampler", "SAINTSampler", "ShaDowKHopSampler"]


class ClusterGCNSampler(Sampler):
    """Cluster-GCN (reference ``cluster_gcn.py``): the graph split once
    into ``k`` parts by the multilevel partitioner
    (``distributed.partition.metis_partition_assignment``); a minibatch
    is the node subgraph of the concatenated nodes of the parts
    ``cluster_ids``, each part's in id order. Iterate the part ids with a
    ``DataLoader``."""

    def __init__(self, g, k: int, balance_ntypes=None, cache_path=None,
                 seed=None):
        from ..distributed.partition import metis_partition_assignment

        self.k = k
        parts = metis_partition_assignment(g, k)
        self.part_nodes = [np.nonzero(parts == p)[0] for p in range(k)]

    def sample(self, g, cluster_ids):
        from ..subgraph import node_subgraph

        cluster_ids = np.atleast_1d(_asnumpy(cluster_ids))
        return node_subgraph(g, np.concatenate(
            [self.part_nodes[int(c)] for c in cluster_ids]))


class SAINTSampler(Sampler):
    """GraphSAINT (reference ``saint.py``): a node-, edge- or
    random-walk-induced subgraph of a fixed ``budget`` (walk: ``(roots,
    length)``), drawn from the numpy generator made from ``seed``."""

    def __init__(self, mode: str, budget, cache=True, seed=None):
        if mode not in ("node", "edge", "walk"):
            raise DGLError("mode must be node|edge|walk")
        self.mode = mode
        self.budget = budget
        self._rng = np.random.default_rng(seed)

    def sample(self, g, indices=None):
        from ..sampling.randomwalks import _walk_host
        from ..subgraph import edge_subgraph, node_subgraph

        if self.mode == "node":
            # nodes in proportion to in-degree + 1
            deg = _asnumpy(g.in_degrees()).astype(np.float64) + 1
            nodes = np.unique(self._rng.choice(g.num_nodes(), self.budget,
                                               p=deg / deg.sum()))
            return node_subgraph(g, nodes)
        if self.mode == "edge":
            E = g.num_edges()
            return edge_subgraph(g, self._rng.choice(
                E, min(self.budget, E), replace=False))
        num_roots, length = self.budget
        roots = self._rng.integers(0, g.num_nodes(), num_roots)
        traces, _, _ = _walk_host(g, roots, length=length,
                                  seed=int(self._rng.integers(2**31)))
        return node_subgraph(g, np.unique(traces[traces >= 0]))


class ShaDowKHopSampler(Sampler):
    """ShaDow-GNN (reference ``shadow.py``): the subgraph induced by the
    nodes a batch's seeds reach in ``len(fanouts)`` sampled hops, the
    seeds first. ``sample`` returns ``(node_ids, seeds, subgraph)``, the
    ids as int64 on the graph's device."""

    def __init__(self, fanouts: Sequence[int], replace=False, prob=None,
                 seed=None):
        self.fanouts = list(fanouts)
        self.replace = replace
        self.prob = prob
        self._rng = np.random.default_rng(seed)

    def sample(self, g, seed_nodes, exclude_eids=None):
        from ..sampling.neighbor import _neighbor_picks
        from ..subgraph import node_subgraph

        seed_nodes = np.atleast_1d(_asnumpy(seed_nodes))
        src_all = g._relation(None).host_arrays("src")[0]
        all_nodes, cur = [seed_nodes], seed_nodes
        for fanout in reversed(self.fanouts):
            picked = _neighbor_picks(
                g, cur, fanout, replace=self.replace, prob=self.prob,
                exclude_edges=exclude_eids,
                seed=int(self._rng.integers(2**31)))
            cur = np.unique(src_all[picked[g.canonical_etypes[0]]])
            all_nodes.append(cur)
        nodes = np.unique(np.concatenate(all_nodes))
        order = np.concatenate([seed_nodes, np.setdiff1d(nodes, seed_nodes)])
        sg = node_subgraph(g, order)
        return (torch.from_numpy(order.astype(np.int64)).to(g.device),
                torch.from_numpy(seed_nodes.astype(np.int64)).to(g.device),
                sg)
