"""Batching graphs into one disjoint union (counterpart of
``dgl_tpu/batch.py``; reference ``python/dgl/batch.py:13``, ``:256``).

Batching runs on the host (numpy) at data-preparation time; the result is
one graph on the first graph's device whose per-graph sizes live in
``batch_num_nodes``/``batch_num_edges``, which the readouts take as
segment lengths.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from .base import EID, NID, DGLError
from .convert import heterograph
from .graph import Graph, _asnumpy

__all__ = ["batch", "unbatch", "stack_graphs", "pad_batch", "slice_batch"]


def batch(graphs: Sequence[Graph]) -> Graph:
    """The disjoint union of ``graphs``, node and edge ids offset graph by
    graph, and the features every graph has concatenated (reference
    ``batch.py:13``)."""
    if len(graphs) == 0:
        raise DGLError("batch() needs at least one graph")
    g0 = graphs[0]
    cets = g0.canonical_etypes
    ntypes = g0.ntypes
    for g in graphs:
        if g.canonical_etypes != cets:
            raise DGLError("All graphs must share the same canonical etypes")
    data = {cet: ([], []) for cet in cets}
    num_nodes = {nt: 0 for nt in ntypes}
    bnn = {nt: [] for nt in ntypes}
    bne = {cet: [] for cet in cets}
    for g in graphs:
        for cet in cets:
            st, _, dt = cet
            rel = g._relations[cet]
            src, dst = rel.host_edges()
            data[cet][0].append(src + num_nodes[st])
            data[cet][1].append(dst + num_nodes[dt])
            bne[cet].append(rel.num_edges)
        for nt in ntypes:
            bnn[nt].append(g.num_nodes(nt))
            num_nodes[nt] += g.num_nodes(nt)
    merged = {cet: (np.concatenate(s), np.concatenate(d))
              for cet, (s, d) in data.items()}
    bg = heterograph(merged, num_nodes, idtype=g0.idtype, device=g0.device)
    bg.set_batch_num_nodes({nt: np.array(v) for nt, v in bnn.items()})
    bg.set_batch_num_edges({cet: np.array(v) for cet, v in bne.items()})
    for nt in ntypes:
        for key in g0._node_frames.get(nt, {}):
            if all(key in g._node_frames.get(nt, {}) for g in graphs):
                bg._node_frames.setdefault(nt, {})[key] = torch.cat(
                    [g._node_frames[nt][key] for g in graphs])
    for cet in cets:
        for key in g0._edge_frames.get(cet, {}):
            if all(key in g._edge_frames.get(cet, {}) for g in graphs):
                bg._edge_frames.setdefault(cet, {})[key] = torch.cat(
                    [g._edge_frames[cet][key][: g._relations[cet].num_edges]
                     for g in graphs])
    return bg


def pad_batch(graphs: Sequence[Graph], batch_size: int, num_nodes: int,
              num_edges: int):
    """Batch to a fixed shape: exactly ``batch_size`` graphs, ``num_nodes``
    nodes and ``num_edges`` edges, the slack in ghost graphs (the JAX
    package's static-shape helper; the reference has none).

    Ghosts are one-node graphs with no edge, the last one taking the
    remaining nodes and, as self-loops on its node 0, the remaining edges;
    their features are 0. Returns ``(bg, gmask)``, ``gmask`` a
    (batch_size,) bool tensor marking the real graphs. Homogeneous graphs
    only."""
    graphs = list(graphs)
    B = len(graphs)
    if B >= batch_size:
        raise DGLError(
            f"need batch_size > len(graphs) (got {batch_size} vs {B}); "
            "at least one ghost graph absorbs the node/edge slack")
    g0 = graphs[0]
    if len(g0.ntypes) != 1 or len(g0.canonical_etypes) != 1:
        raise DGLError("pad_batch supports homogeneous graphs only")
    nt = g0.ntypes[0]
    cet = g0.canonical_etypes[0]
    total_n = sum(g.num_nodes() for g in graphs)
    total_e = sum(g.num_edges() for g in graphs)
    n_ghost = batch_size - B
    spare_n = num_nodes - total_n
    spare_e = num_edges - total_e
    if spare_n < n_ghost:
        raise DGLError(
            f"num_nodes={num_nodes} too small: {total_n} real nodes + "
            f"{n_ghost} ghost graphs (1 node min each)")
    if spare_e < 0:
        raise DGLError(f"num_edges={num_edges} too small for {total_e} "
                       "edges")

    def ghost(n, e):
        loops = np.zeros(e, np.int64)
        g = heterograph({cet: (loops, loops)}, {nt: n}, idtype=g0.idtype,
                        device=g0.device)
        for k, v in g0._node_frames.get(nt, {}).items():
            g._node_frames.setdefault(nt, {})[k] = v.new_zeros(
                (n,) + tuple(v.shape[1:]))
        ep = g._relations[cet].num_edges_padded
        for k, v in g0._edge_frames.get(cet, {}).items():
            g._edge_frames.setdefault(cet, {})[k] = v.new_zeros(
                (ep,) + tuple(v.shape[1:]))
        return g

    ghosts = [ghost(1, 0) for _ in range(n_ghost - 1)]
    ghosts.append(ghost(spare_n - (n_ghost - 1), spare_e))
    bg = batch(graphs + ghosts)
    # the degree bounds are those of any batch of these sizes, as in the
    # reference (UDF mailboxes at the worst case)
    for r in bg._relations.values():
        r.max_in_degree = r.num_edges_padded
        r.max_out_degree = r.num_edges_padded
    gmask = torch.zeros(batch_size, dtype=torch.bool, device=g0.device)
    gmask[:B] = True
    return bg, gmask


def _offsets(counts: np.ndarray) -> np.ndarray:
    return np.concatenate([[0], np.cumsum(counts)])


def unbatch(bg: Graph) -> List[Graph]:
    """The graphs of a batch, features sliced (reference ``batch.py:256``)."""
    cets, ntypes = bg.canonical_etypes, bg.ntypes
    bnn = {nt: _asnumpy(bg.batch_num_nodes(nt)) for nt in ntypes}
    bne = {cet: _asnumpy(bg.batch_num_edges(cet)) for cet in cets}
    node_off = {nt: _offsets(bnn[nt]) for nt in ntypes}
    edge_off = {cet: _offsets(bne[cet]) for cet in cets}
    return [_one_graph(bg, {nt: (node_off[nt][i], node_off[nt][i + 1])
                            for nt in ntypes},
                       {cet: (edge_off[cet][i], edge_off[cet][i + 1])
                        for cet in cets})
            for i in range(bg.batch_size)]


def _one_graph(bg: Graph, nodes, edges, store_ids: bool = False) -> Graph:
    """The graph of a batch whose nodes and edges are the ranges ``nodes``
    (by type) and ``edges`` (by edge type)."""
    data = {}
    for (st, et, dt), (lo, hi) in edges.items():
        src, dst = bg._relations[(st, et, dt)].host_arrays("src", "dst")
        data[(st, et, dt)] = (src[lo:hi] - nodes[st][0],
                              dst[lo:hi] - nodes[dt][0])
    g = heterograph(data, {nt: int(hi - lo) for nt, (lo, hi) in nodes.items()},
                    idtype=bg.idtype, device=bg.device)
    for nt, (lo, hi) in nodes.items():
        frame = g._node_frames.setdefault(nt, {})
        for key, v in bg._node_frames.get(nt, {}).items():
            frame[key] = v[lo:hi]
        if store_ids:
            frame[NID] = torch.arange(lo, hi, device=bg.device)
    for cet, (lo, hi) in edges.items():
        frame = g._edge_frames.setdefault(cet, {})
        for key, v in bg._edge_frames.get(cet, {}).items():
            frame[key] = v[lo:hi]
        if store_ids:
            frame[EID] = torch.arange(lo, hi, device=bg.device)
    return g


def slice_batch(bg: Graph, gid: int, store_ids: bool = False) -> Graph:
    """Graph ``gid`` of a batch, without unbatching the rest (reference
    ``batch.py:446``); with ``store_ids`` its ids in the batch in
    ``NID``/``EID``."""
    if not 0 <= gid < bg.batch_size:
        raise DGLError(f"gid {gid} out of range for batch of "
                       f"{bg.batch_size}")
    nodes, edges = {}, {}
    for nt in bg.ntypes:
        counts = _asnumpy(bg.batch_num_nodes(nt))
        lo = int(counts[:gid].sum())
        nodes[nt] = (lo, lo + int(counts[gid]))
    for cet in bg.canonical_etypes:
        counts = _asnumpy(bg.batch_num_edges(cet))
        lo = int(counts[:gid].sum())
        edges[cet] = (lo, lo + int(counts[gid]))
    return _one_graph(bg, nodes, edges, store_ids)


def stack_graphs(graphs: Sequence[Graph]) -> Graph:
    """Graphs of equal shapes stacked along a new leading axis: every index
    tensor and feature of the result is (B, ...), the degree bounds the
    largest of the graphs' (the JAX package's layout for ``vmap``; the
    reference has none)."""
    graphs = list(graphs)
    g0 = graphs[0]
    rels = {}
    for cet, r0 in g0._relations.items():
        arrays = {f: torch.stack([getattr(g._relations[cet], f)
                                  for g in graphs])
                  for f in r0.ARRAY_FIELDS}
        rels[cet] = r0._copy_with(_host={}, **arrays)
    mi = max(r.max_in_degree for g in graphs for r in g._relations.values())
    mo = max(r.max_out_degree for g in graphs for r in g._relations.values())
    for r in rels.values():
        r.max_in_degree, r.max_out_degree = mi, mo
    out = g0.structural_clone()
    out._relations = rels

    def stack(attr):
        return {k: {f: torch.stack([getattr(g, attr)[k][f] for g in graphs])
                    for f in frame}
                for k, frame in getattr(g0, attr).items()}

    out._node_frames = stack("_node_frames")
    out._dst_frames = (out._node_frames if not g0.is_block
                       else stack("_dst_frames"))
    out._edge_frames = stack("_edge_frames")
    return out
