"""Capped-frontier subgraph sampler (counterpart of
``dgl_tpu/dataloading/capped.py``; reference
``python/dgl/dataloading/capped_neighbor_sampler.py:11``): each layer's
frontier is cut to ``fixed_k`` nodes (rare node types optionally
upsampled by square-rooted shares), and the batch is the subgraph induced
by every node reached."""
from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from ..base import NID
from ..graph import _asnumpy
from .base import Sampler

__all__ = ["CappedNeighborSampler"]


class CappedNeighborSampler(Sampler):
    """``sample(g, indices, exclude_eids=None)`` returns ``(input_nodes,
    output_nodes, subgraph)``: the parent ids behind the subgraph's nodes
    in its order (so ``feat[input_nodes]`` lines up with its rows), the
    seeds, and the subgraph on ``g``'s device; ids by type on a
    heterograph. Draws from the numpy generator made from ``seed``."""

    def __init__(self, fanouts, fixed_k: int, upsample_rare_types: bool,
                 replace: bool = False, prob: Optional[str] = None,
                 prefetch_node_feats=None, prefetch_edge_feats=None,
                 output_device=None, seed: Optional[int] = None):
        self.fanouts = fanouts
        self.fixed_k = int(fixed_k)
        self.upsample_rare_types = upsample_rare_types
        self.replace = replace
        self.prob = prob
        self.prefetch_node_feats = prefetch_node_feats
        self.prefetch_edge_feats = prefetch_edge_feats
        self.output_device = output_device
        self._rng = np.random.default_rng(seed)

    def sample(self, g, indices, exclude_eids=None):
        from ..sampling.neighbor import _neighbor_picks
        from ..sampling.utils import EidExcluder
        from ..subgraph import node_subgraph

        if not isinstance(indices, Mapping):
            indices = {g.ntypes[0]: _asnumpy(indices)}
        else:
            indices = {nt: _asnumpy(v) for nt, v in indices.items()}
        output_nodes = indices
        all_reached = [indices]
        for fanout in reversed(list(self.fanouts)):
            picked = _neighbor_picks(
                g, indices, fanout, replace=self.replace, prob=self.prob,
                exclude_edges=exclude_eids,
                seed=int(self._rng.integers(2**63)))
            reached = {}
            for cet, eids in picked.items():
                src = g._relations[cet].host_arrays("src")[0][eids]
                reached.setdefault(cet[0], []).append(src)
            reached = {nt: np.unique(np.concatenate(srcs))
                       for nt, srcs in reached.items() if srcs}
            if not reached:
                break
            total = sum(ids.shape[0] for ids in reached.values())
            probs = {nt: ids.shape[0] / total for nt, ids in reached.items()}
            if self.upsample_rare_types:
                dist = np.sqrt(np.asarray(list(probs.values())))
                dist = dist / dist.sum()
                probs = {nt: dist[i] for i, nt in enumerate(probs)}
            n_per = {nt: int(self.fixed_k * p) for nt, p in probs.items()}
            remainder = self.fixed_k - sum(n_per.values())
            types = list(probs.keys())
            pvals = np.asarray([probs[t] for t in types])
            for _ in range(remainder):
                n_per[types[self._rng.choice(len(types), p=pvals)]] += 1
            capped = {}
            for nt, ids in reached.items():
                k = min(ids.shape[0], n_per[nt])
                capped[nt] = ids[self._rng.permutation(ids.shape[0])[:k]]
            indices = capped
            all_reached.append(capped)
        merged = {}
        for nt in g.ntypes:
            parts = [r[nt] for r in all_reached if nt in r]
            if parts:
                merged[nt] = np.unique(np.concatenate(parts))
        subg = node_subgraph(g, merged)
        if exclude_eids is not None:
            subg = EidExcluder(exclude_eids)(subg)

        def ids(a):
            return torch.from_numpy(np.asarray(a, np.int64)).to(g.device)

        if len(g.ntypes) == 1:
            nt = g.ntypes[0]
            return subg.ndata[NID], ids(output_nodes[nt]), subg
        return ({nt: subg.nodes[nt].data[NID] for nt in subg.ntypes},
                {nt: ids(v) for nt, v in output_nodes.items()}, subg)
