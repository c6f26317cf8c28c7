"""Subgraph extraction (counterpart of ``dgl_tpu/subgraph.py``; reference
``python/dgl/subgraph.py``, C++ ``src/graph/subgraph.cc``).

Extraction changes the structure, so it runs on the host with numpy, where
the reference crosses into C++; the result lies on the input graph's
device. The induced node and edge ids are stored in ``ndata[NID]`` and
``edata[EID]`` as in the reference.
"""
from __future__ import annotations

from typing import Dict, Mapping, Sequence

import numpy as np
import torch

from .base import EID, NID, DGLError
from .graph import (Graph, Relation, _asnumpy, _np_idtype, ragged_gather,
                    unique_first_occurrence)

__all__ = [
    "node_subgraph",
    "edge_subgraph",
    "in_subgraph",
    "out_subgraph",
    "khop_in_subgraph",
    "khop_out_subgraph",
    "node_type_subgraph",
    "edge_type_subgraph",
]


def _nodes_dict(g: Graph, nodes) -> Dict[str, np.ndarray]:
    """A nodes argument as {ntype: int64 ids} (bool masks allowed)."""
    if not isinstance(nodes, Mapping):
        if len(g.ntypes) != 1:
            raise DGLError("node dict required for graphs with multiple "
                           "ntypes")
        nodes = {g.ntypes[0]: nodes}
    out = {}
    for nt, v in nodes.items():
        v = _asnumpy(v)
        if v.dtype == bool:
            v = np.nonzero(v)[0]
        out[nt] = v.astype(np.int64)
    return out


def _gather_frames(g: Graph, frames: Dict[str, Dict], key, ids, id_field):
    """A frame sliced by ``ids``, with the ids under ``id_field``."""
    idx = torch.from_numpy(np.ascontiguousarray(ids)).to(g.device)
    sliced = {k: v[idx] for k, v in frames.get(key, {}).items()}
    sliced[id_field] = idx
    return sliced


def node_subgraph(g: Graph, nodes, *, relabel_nodes: bool = True,
                  store_ids: bool = True) -> Graph:
    """The subgraph induced by ``nodes``, nodes in the given order and
    edges in id order (reference ``subgraph.py:23``)."""
    nodes = _nodes_dict(g, nodes)
    np_id = _np_idtype(g.idtype)
    maps, counts = {}, {}
    for nt in g.ntypes:
        keep = nodes.get(nt, np.zeros(0, dtype=np.int64))
        m = np.full(g.num_nodes(nt), -1, dtype=np.int64)
        m[keep] = np.arange(keep.size)
        maps[nt] = m
        counts[nt] = int(keep.size)
    rels, eids_per = {}, {}
    for cet in g.canonical_etypes:
        st, _, dt = cet
        src, dst = g._relations[cet].host_edges()
        eids = np.nonzero((maps[st][src] >= 0) & (maps[dt][dst] >= 0))[0]
        rels[cet] = Relation.from_coo(
            maps[st][src[eids]], maps[dt][dst[eids]], counts[st],
            counts[dt], idtype=g.idtype, device=g.device)
        eids_per[cet] = eids.astype(np_id)
    sub = Graph(rels, {nt: counts[nt] for nt in g.ntypes})
    for nt in g.ntypes:
        sub._node_frames[nt] = _gather_frames(
            g, g._node_frames, nt, nodes.get(nt, np.zeros(0, np.int64)), NID)
        if not store_ids:
            sub._node_frames[nt].pop(NID, None)
    for cet in g.canonical_etypes:
        sub._edge_frames[cet] = _gather_frames(g, g._edge_frames, cet,
                                               eids_per[cet], EID)
        if not store_ids:
            sub._edge_frames[cet].pop(EID, None)
    return sub


def edge_subgraph(g: Graph, edges, *, relabel_nodes: bool = True,
                  store_ids: bool = True) -> Graph:
    """The subgraph of the edges ``edges`` (reference ``subgraph.py:248``);
    with ``relabel_nodes`` its nodes are their endpoints, a type's in
    order of first appearance over the edge types' sources and
    destinations."""
    if not isinstance(edges, Mapping):
        if len(g.canonical_etypes) != 1:
            raise DGLError("edge dict required for graphs with multiple "
                           "etypes")
        edges = {g.canonical_etypes[0]: edges}
    edges = {g.to_canonical_etype(k): (
        np.nonzero(_asnumpy(v))[0] if _asnumpy(v).dtype == bool
        else _asnumpy(v).astype(np.int64)) for k, v in edges.items()}
    np_id = _np_idtype(g.idtype)
    empty = np.zeros(0, np.int64)
    if not relabel_nodes:
        rels = {}
        for cet in g.canonical_etypes:
            src, dst = g._relations[cet].host_arrays("src", "dst")
            eids = edges.get(cet, empty)
            rels[cet] = Relation.from_coo(
                src[eids], dst[eids], g.num_nodes(cet[0]),
                g.num_nodes(cet[2]), idtype=g.idtype, device=g.device)
        sub = Graph(rels, {nt: g.num_nodes(nt) for nt in g.ntypes})
        for nt in g.ntypes:
            sub._node_frames[nt] = dict(g._node_frames.get(nt, {}))
        for cet in g.canonical_etypes:
            sub._edge_frames[cet] = _gather_frames(
                g, g._edge_frames, cet, edges.get(cet, empty), EID)
            if not store_ids:
                sub._edge_frames[cet].pop(EID, None)
        return sub
    per_edge = {}
    streams: Dict[str, list] = {nt: [] for nt in g.ntypes}
    for cet in g.canonical_etypes:
        src, dst = g._relations[cet].host_arrays("src", "dst")
        eids = edges.get(cet, empty)
        s, d = src[eids], dst[eids]
        per_edge[cet] = (eids, s, d)
        streams[cet[0]].append(s.astype(np.int64))
        streams[cet[2]].append(d.astype(np.int64))
    node_ids, maps = {}, {}
    for nt in g.ntypes:
        ids, _ = unique_first_occurrence(
            np.concatenate(streams[nt]) if streams[nt] else empty)
        node_ids[nt] = ids
        m = np.full(g.num_nodes(nt), -1, dtype=np.int64)
        m[ids] = np.arange(ids.size)
        maps[nt] = m
    rels = {}
    for cet, (eids, s, d) in per_edge.items():
        st, _, dt = cet
        rels[cet] = Relation.from_coo(
            maps[st][s], maps[dt][d], node_ids[st].shape[0],
            node_ids[dt].shape[0], idtype=g.idtype, device=g.device)
    sub = Graph(rels, {nt: node_ids[nt].shape[0] for nt in g.ntypes})
    for nt in g.ntypes:
        sub._node_frames[nt] = _gather_frames(g, g._node_frames, nt,
                                              node_ids[nt], NID)
        if not store_ids:
            sub._node_frames[nt].pop(NID, None)
    for cet, (eids, _, _) in per_edge.items():
        sub._edge_frames[cet] = _gather_frames(
            g, g._edge_frames, cet, eids.astype(np_id), EID)
        if not store_ids:
            sub._edge_frames[cet].pop(EID, None)
    return sub


def in_subgraph(g: Graph, nodes, *, relabel_nodes: bool = False,
                store_ids: bool = True) -> Graph:
    """The subgraph of every in-edge of ``nodes``, node by node in CSC
    order (reference ``subgraph.py:428``)."""
    nodes = _nodes_dict(g, nodes)
    edges = {}
    for cet in g.canonical_etypes:
        indptr, eids = g._relations[cet].host_arrays("csc_indptr",
                                                     "csc_eids")
        edges[cet] = ragged_gather(indptr, eids, nodes.get(
            cet[2], np.zeros(0, np.int64)))
    return edge_subgraph(g, edges, relabel_nodes=relabel_nodes,
                         store_ids=store_ids)


def out_subgraph(g: Graph, nodes, *, relabel_nodes: bool = False,
                 store_ids: bool = True) -> Graph:
    """The subgraph of every out-edge of ``nodes``, node by node in CSR
    order (reference ``subgraph.py:524``)."""
    nodes = _nodes_dict(g, nodes)
    edges = {}
    for cet in g.canonical_etypes:
        indptr, eids = g._relations[cet].host_arrays("csr_indptr",
                                                     "csr_eids")
        edges[cet] = ragged_gather(indptr, eids, nodes.get(
            cet[0], np.zeros(0, np.int64)))
    return edge_subgraph(g, edges, relabel_nodes=relabel_nodes,
                         store_ids=store_ids)


def _khop_subgraph(g: Graph, nodes, k: int, inbound: bool):
    """The node subgraph of everything within ``k`` hops of ``nodes``
    (sorted ids), and the seeds' positions in it. Each hop gathers the
    frontier's CSC (in) or CSR (out) runs at once."""
    nodes = _nodes_dict(g, nodes)
    empty = np.zeros(0, np.int64)
    visited = {nt: np.zeros(g.num_nodes(nt), dtype=bool) for nt in g.ntypes}
    frontier = {}
    for nt in g.ntypes:
        visited[nt][nodes.get(nt, empty)] = True
        frontier[nt] = np.nonzero(visited[nt])[0]
    for _ in range(k):
        reached = {nt: np.zeros(g.num_nodes(nt), dtype=bool)
                   for nt in g.ntypes}
        for cet in g.canonical_etypes:
            st, _, dt = cet
            rel = g._relations[cet]
            if inbound:
                indptr, ids = rel.host_arrays("csc_indptr", "csc_indices")
                seeds, tgt = frontier[dt], st
            else:
                indptr, ids = rel.host_arrays("csr_indptr", "csr_indices")
                seeds, tgt = frontier[st], dt
            reached[tgt][ragged_gather(indptr, ids, seeds)] = True
        frontier = {}
        for nt in g.ntypes:
            new = reached[nt] & ~visited[nt]
            visited[nt] |= new
            frontier[nt] = np.nonzero(new)[0]
    keep = {nt: np.nonzero(m)[0] for nt, m in visited.items()}
    sub = node_subgraph(g, keep)
    inv = {nt: torch.from_numpy(np.searchsorted(keep[nt], v)).to(g.device)
           for nt, v in nodes.items()}
    if len(g.ntypes) == 1:
        inv = inv[g.ntypes[0]]
    return sub, inv


def khop_in_subgraph(g: Graph, nodes, k: int, *, relabel_nodes: bool = True,
                     store_ids: bool = True):
    """The k-hop inbound subgraph and the seeds' positions in it
    (reference ``subgraph.py:620``)."""
    return _khop_subgraph(g, nodes, k, inbound=True)


def khop_out_subgraph(g: Graph, nodes, k: int, *, relabel_nodes: bool = True,
                      store_ids: bool = True):
    """The k-hop outbound subgraph and the seeds' positions in it
    (reference ``subgraph.py:738``)."""
    return _khop_subgraph(g, nodes, k, inbound=False)


def node_type_subgraph(g: Graph, ntypes: Sequence[str]) -> Graph:
    """The relations among the given node types, plans and frames kept
    (reference ``subgraph.py:860``)."""
    keep = set(ntypes)
    rels = {cet: rel for cet, rel in g._relations.items()
            if cet[0] in keep and cet[2] in keep}
    sub = Graph(rels, {nt: g.num_nodes(nt) for nt in ntypes})
    for nt in ntypes:
        sub._node_frames[nt] = dict(g._node_frames.get(nt, {}))
    for cet in rels:
        sub._edge_frames[cet] = dict(g._edge_frames.get(cet, {}))
    return sub


def edge_type_subgraph(g: Graph, etypes: Sequence) -> Graph:
    """The given edge types and their node types, plans and frames kept
    (reference ``subgraph.py:920``)."""
    cets = [g.to_canonical_etype(et) for et in etypes]
    ntypes = []
    for st, _, dt in cets:
        for nt in (st, dt):
            if nt not in ntypes:
                ntypes.append(nt)
    rels = {cet: g._relations[cet] for cet in cets}
    sub = Graph(rels, {nt: g.num_nodes(nt) for nt in ntypes})
    for nt in ntypes:
        sub._node_frames[nt] = dict(g._node_frames.get(nt, {}))
    for cet in cets:
        sub._edge_frames[cet] = dict(g._edge_frames.get(cet, {}))
    return sub
