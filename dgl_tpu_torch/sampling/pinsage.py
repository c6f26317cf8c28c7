"""PinSAGE's random-walk neighbour samplers (counterpart of
``dgl_tpu/sampling/pinsage.py``; reference ``python/dgl/sampling/
pinsage.py``): repeated metapath walks from each seed; the nodes visited
most often become its neighbours, their visit counts the edge weights."""
from __future__ import annotations

from collections import Counter
from typing import Optional

import numpy as np
import torch

from ..base import DGLError
from ..graph import Graph, _asnumpy
from .randomwalks import _walk_host

__all__ = ["RandomWalkNeighborSampler", "PinSAGESampler"]


class RandomWalkNeighborSampler:
    """(reference ``pinsage.py:14``). Calling it with seed ids returns a
    graph over ``G``'s nodes of the metapath's type, on ``G``'s device:
    an edge from each of a seed's ``num_neighbors`` most visited nodes to
    the seed, its visit count in ``edata[weight_column]`` (float32)."""

    def __init__(self, G: Graph, num_traversals: int,
                 termination_prob: float, num_random_walks: int,
                 num_neighbors: int, metapath=None,
                 weight_column: str = "weights", seed: Optional[int] = None):
        self.G = G
        self.num_traversals = num_traversals
        self.termination_prob = termination_prob
        self.num_random_walks = num_random_walks
        self.num_neighbors = num_neighbors
        self.weight_column = weight_column
        self._seed = seed
        if metapath is None:
            if len(G.canonical_etypes) > 1:
                raise DGLError("metapath required for heterographs")
            metapath = [G.canonical_etypes[0]]
        self.metapath = [G.to_canonical_etype(et) for et in metapath]
        if self.metapath[0][0] != self.metapath[-1][2]:
            raise DGLError("metapath must start and end at the same node "
                           "type")
        self.ntype = self.metapath[0][0]
        self.full_path = list(self.metapath) * num_traversals

    def __call__(self, seed_nodes) -> Graph:
        from ..convert import graph

        seed_nodes = np.atleast_1d(_asnumpy(seed_nodes)).astype(np.int64)
        counters = {int(s): Counter() for s in seed_nodes}
        L = len(self.metapath)
        rep = np.repeat(seed_nodes, self.num_random_walks)
        traces, _, _ = _walk_host(self.G, rep, metapath=self.full_path,
                                  restart_prob=self.termination_prob,
                                  seed=self._seed)
        # a visit at a multiple of the metapath's length is of the seed's
        # type
        for row, s in zip(traces, rep):
            for t in range(L, traces.shape[1], L):
                v = int(row[t])
                if v < 0:
                    break
                counters[int(s)][v] += 1
        src, dst, w = [], [], []
        for s in seed_nodes:
            for v, c in counters[int(s)].most_common(self.num_neighbors):
                src.append(v)
                dst.append(int(s))
                w.append(c)
        out = graph((np.array(src, np.int64), np.array(dst, np.int64)),
                    num_nodes=self.G.num_nodes(self.ntype),
                    device=self.G.device)
        out.edata[self.weight_column] = torch.tensor(
            np.array(w, np.float32), device=self.G.device)
        return out


class PinSAGESampler(RandomWalkNeighborSampler):
    """(reference ``pinsage.py:84``): walks ``ntype -> other_type ->
    ntype``."""

    def __init__(self, G: Graph, ntype: str, other_type: str,
                 num_traversals: int, termination_prob: float,
                 num_random_walks: int, num_neighbors: int,
                 weight_column: str = "weights", seed: Optional[int] = None):
        fw = [c for c in G.canonical_etypes
              if c[0] == ntype and c[2] == other_type]
        bw = [c for c in G.canonical_etypes
              if c[0] == other_type and c[2] == ntype]
        if not fw or not bw:
            raise DGLError(f"need etypes {ntype}->{other_type} and "
                           f"{other_type}->{ntype}")
        super().__init__(G, num_traversals, termination_prob,
                         num_random_walks, num_neighbors,
                         metapath=[fw[0], bw[0]],
                         weight_column=weight_column, seed=seed)
