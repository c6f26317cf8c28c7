"""Hot-seed graph-structure cache and the in-subgraph fetch stages
(counterpart of ``dgl_tpu/graphbolt/impl/graph_cache.py``; reference
``graphbolt/src/cuda/extension/gpu_graph_cache.cu``,
``python/dgl/graphbolt/impl/gpu_graph_cache.py`` and the
``FetchInsubgraphData`` / ``FetchCachedInsubgraphData`` /
``CombineCachedAndFetchedInSubgraph`` stages in
``impl/neighbor_sampler.py``).

The reference caches CSC rows of frequently sampled seeds in GPU memory
to skip host-to-device structure transfers. The sampling graph here is a
host CSC, so the cache skips repeated CSC row slicing for hot seeds:
per-seed (indices, eids) rows are memoised with a bounded FIFO. Stages:

- ``FetchInsubgraphData``: attach each seed's full in-neighbourhood.
- ``FetchCachedInsubgraphData``: probe the cache; split hits and misses.
- ``CombineCachedAndFetchedInSubgraph``: fetch the misses, admit them,
  and merge them with the hits into one SampledSubgraphImpl.
"""
from __future__ import annotations

import numpy as np

from ...graph import _asnumpy
from ..neighbor_sampler_gb import _Stage
from .fused_csc_sampling_graph import CSCFormatBase, SampledSubgraphImpl

__all__ = [
    "GPUGraphCache",
    "FetchInsubgraphData",
    "FetchCachedInsubgraphData",
    "CombineCachedAndFetchedInSubgraph",
]


class GPUGraphCache:
    """Bounded per-seed structure cache (reference name; the module
    docstring says what it caches here)."""

    def __init__(self, capacity: int):
        self.capacity = int(capacity)
        self._rows = {}          # seed -> (indices, eids)
        self._order = []         # FIFO admission order
        self.hits = 0
        self.misses = 0

    def query(self, seeds: np.ndarray):
        """(hit_mask, rows): rows[i] is (indices, eids) for hits else
        None."""
        seeds = np.asarray(seeds)
        rows = []
        hit = np.zeros(seeds.shape[0], dtype=bool)
        for i, s in enumerate(seeds.tolist()):
            r = self._rows.get(s)
            if r is not None:
                hit[i] = True
                self.hits += 1
                rows.append(r)
            else:
                self.misses += 1
                rows.append(None)
        return hit, rows

    def replace(self, seeds: np.ndarray, rows):
        for s, r in zip(np.asarray(seeds).tolist(), rows):
            if s in self._rows:
                continue
            if len(self._rows) >= self.capacity:
                evict = self._order.pop(0)
                self._rows.pop(evict, None)
            self._rows[s] = r
            self._order.append(s)

    @property
    def hit_rate(self):
        total = self.hits + self.misses
        return self.hits / total if total else 0.0


def _rows_of(graph, seeds: np.ndarray):
    """Slice CSC rows for each seed: list of (indices, eids)."""
    out = []
    for s in np.asarray(seeds).tolist():
        lo, hi = int(graph.csc_indptr[s]), int(graph.csc_indptr[s + 1])
        out.append((graph.indices[lo:hi], graph._eids[lo:hi]))
    return out


def _assemble(seeds: np.ndarray, rows) -> SampledSubgraphImpl:
    seeds = np.asarray(seeds)
    degs = np.asarray([r[0].shape[0] for r in rows], dtype=np.int64)
    indptr = np.concatenate([[0], np.cumsum(degs)])
    indices = (
        np.concatenate([r[0] for r in rows]) if rows
        else np.zeros(0, np.int64)
    )
    eids = (
        np.concatenate([r[1] for r in rows]) if rows
        else np.zeros(0, np.int64)
    )
    return SampledSubgraphImpl(
        sampled_csc=CSCFormatBase(indptr=indptr, indices=indices),
        original_column_node_ids=seeds,
        original_edge_ids=eids,
    )


class FetchInsubgraphData(_Stage):
    """Attach each minibatch's full in-subgraph (reference stage of the
    same name): no cache, direct CSC slicing."""

    def __init__(self, source, graph):
        super().__init__(source)
        self.graph = graph

    def _apply(self, mb):
        seeds = _asnumpy(mb.seeds).ravel()
        sub = _assemble(seeds, _rows_of(self.graph, seeds))
        mb.sampled_subgraphs = [sub]
        mb.input_nodes = np.unique(
            np.concatenate([seeds, sub.sampled_csc.indices])
        )
        return mb


class FetchCachedInsubgraphData(_Stage):
    """Probe the graph cache; stash hits and the miss list on the
    minibatch for the combine stage (reference stage of the same name)."""

    def __init__(self, source, graph, cache: GPUGraphCache):
        super().__init__(source)
        self.graph = graph
        self.cache = cache

    def _apply(self, mb):
        seeds = _asnumpy(mb.seeds).ravel()
        hit, rows = self.cache.query(seeds)
        mb._gcache = (seeds, hit, rows)
        return mb


class CombineCachedAndFetchedInSubgraph(_Stage):
    """Fetch the cache misses, admit them, and merge with the hits into
    one in-subgraph (reference stage of the same name)."""

    def __init__(self, source, graph, cache: GPUGraphCache):
        super().__init__(source)
        self.graph = graph
        self.cache = cache

    def _apply(self, mb):
        seeds, hit, rows = mb._gcache
        del mb._gcache
        miss_seeds = seeds[~hit]
        fetched = _rows_of(self.graph, miss_seeds)
        self.cache.replace(miss_seeds, fetched)
        it = iter(fetched)
        merged = [r if r is not None else next(it) for r in rows]
        sub = _assemble(seeds, merged)
        mb.sampled_subgraphs = [sub]
        mb.input_nodes = np.unique(
            np.concatenate([seeds, sub.sampled_csc.indices])
        )
        return mb
