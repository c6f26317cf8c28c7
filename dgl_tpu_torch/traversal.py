"""Graph traversal frontiers (counterpart of ``dgl_tpu/traversal.py``;
reference ``python/dgl/traversal.py``, C++ ``src/graph/traversal.cc``).

Host numpy over the relation's CSR (or, ``reversed``, its CSC): the
frontiers are ragged, data-dependent schedules, computed once on the host
and handed to fixed-shape device steps (``propagate.py``). Each generator
returns a list of int64 numpy arrays, the reference's frontiers.
"""
from __future__ import annotations

from typing import List

import numpy as np

from .base import DGLError
from .graph import ragged_gather

__all__ = [
    "bfs_nodes_generator",
    "bfs_edges_generator",
    "topological_nodes_generator",
    "dfs_edges_generator",
    "dfs_labeled_edges_generator",
]


def _csr(g, reverse: bool):
    """The relation's (indptr, neighbours, edge ids), int64, by source
    (by destination with ``reverse``)."""
    rel = g._relation(None)
    fields = (("csc_indptr", "csc_indices", "csc_eids") if reverse
              else ("csr_indptr", "csr_indices", "csr_eids"))
    return tuple(a.astype(np.int64) for a in rel.host_arrays(*fields))


def _expand(indptr, frontier):
    """The CSR offsets of the frontier's out-edges, node after node, each
    node's in CSR order."""
    return ragged_gather(indptr, np.arange(indptr[-1], dtype=np.int64),
                         frontier)


def bfs_nodes_generator(graph, source, reversed=False) -> List[np.ndarray]:
    """The node frontiers of a BFS from ``source`` (reference
    ``traversal.py:12``): each the sorted nodes first reached at that
    depth."""
    indptr, indices, _ = _csr(graph, reversed)
    visited = np.zeros(indptr.shape[0] - 1, dtype=bool)
    frontier = np.atleast_1d(np.asarray(source, dtype=np.int64))
    visited[frontier] = True
    layers = []
    while frontier.size:
        layers.append(frontier)
        nbrs = indices[_expand(indptr, frontier)]
        frontier = np.unique(nbrs[~visited[nbrs]])
        visited[frontier] = True
    return layers


def bfs_edges_generator(graph, source, reversed=False) -> List[np.ndarray]:
    """The edge frontiers of a BFS (reference ``traversal.py:54``): at each
    depth, the edge that first reaches each new node, in the order the
    frontier's nodes (and each node's edges, in CSR order) are scanned;
    the next frontier is those nodes in that order."""
    indptr, indices, eids = _csr(graph, reversed)
    visited = np.zeros(indptr.shape[0] - 1, dtype=bool)
    frontier = np.atleast_1d(np.asarray(source, dtype=np.int64))
    visited[frontier] = True
    layers = []
    while frontier.size:
        offs = _expand(indptr, frontier)
        offs = offs[~visited[indices[offs]]]
        _, first = np.unique(indices[offs], return_index=True)
        offs = offs[np.sort(first)]
        if offs.size:
            layers.append(eids[offs])
        frontier = indices[offs]
        visited[frontier] = True
    return layers


def topological_nodes_generator(graph, reversed=False) -> List[np.ndarray]:
    """Topological frontiers (reference ``traversal.py:97``): the nodes of
    in-degree 0, then those whose last in-edge from a frontier is removed,
    in the order of that edge in the frontier's scan. Raises on a
    cycle."""
    indptr, indices, _ = _csr(graph, reversed)
    n = indptr.shape[0] - 1
    indeg = np.bincount(indices[: indptr[-1]], minlength=n)[:n]
    frontier = np.nonzero(indeg == 0)[0]
    layers = []
    seen = 0
    while frontier.size:
        layers.append(frontier)
        seen += frontier.size
        nbrs = indices[_expand(indptr, frontier)]
        np.subtract.at(indeg, nbrs, 1)
        # a node joins the next frontier at its last occurrence in the scan
        last = nbrs.shape[0] - 1 - np.unique(nbrs[::-1], return_index=True)[1]
        last = np.sort(last[indeg[nbrs[last]] == 0])
        frontier = nbrs[last]
    if seen != n:
        raise DGLError("Graph has cycles; topological traversal undefined")
    return layers


def dfs_edges_generator(graph, source, reversed=False) -> List[np.ndarray]:
    """The tree edges of a DFS from each source in turn, one a frontier
    (reference ``traversal.py:146``)."""
    indptr, indices, eids = _csr(graph, reversed)
    visited = np.zeros(indptr.shape[0] - 1, dtype=bool)
    out = []
    for s in np.atleast_1d(np.asarray(source, dtype=np.int64)):
        if visited[s]:
            continue
        visited[s] = True
        stack = [(int(s), int(indptr[s]))]
        while stack:
            u, off = stack[-1]
            if off >= indptr[u + 1]:
                stack.pop()
                continue
            stack[-1] = (u, off + 1)
            v = indices[off]
            if not visited[v]:
                visited[v] = True
                out.append(eids[off])
                stack.append((int(v), int(indptr[v])))
    return [np.array([e], dtype=np.int64) for e in out]


def dfs_labeled_edges_generator(graph, source, reversed=False,
                                has_reverse_edge=False,
                                has_nontree_edge=False):
    """A DFS's edges labelled FORWARD (0), REVERSE (1, a tree edge again
    when its subtree is done, with ``has_reverse_edge``) and NONTREE (2,
    with ``has_nontree_edge``), one a frontier: (edges, labels)
    (reference ``traversal.py:181``)."""
    FORWARD, REVERSE, NONTREE = 0, 1, 2
    indptr, indices, eids = _csr(graph, reversed)
    visited = np.zeros(indptr.shape[0] - 1, dtype=bool)
    edges, labels = [], []
    for s in np.atleast_1d(np.asarray(source, dtype=np.int64)):
        if visited[s]:
            continue
        visited[s] = True
        stack = [(int(s), int(indptr[s]), -1)]
        while stack:
            u, off, ein = stack[-1]
            if off >= indptr[u + 1]:
                if has_reverse_edge and ein >= 0:
                    edges.append(ein)
                    labels.append(REVERSE)
                stack.pop()
                continue
            stack[-1] = (u, off + 1, ein)
            v = indices[off]
            if not visited[v]:
                visited[v] = True
                edges.append(eids[off])
                labels.append(FORWARD)
                stack.append((int(v), int(indptr[v]), int(eids[off])))
            elif has_nontree_edge:
                edges.append(eids[off])
                labels.append(NONTREE)
    return ([np.array([e], dtype=np.int64) for e in edges],
            [np.array([lab], dtype=np.int64) for lab in labels])
