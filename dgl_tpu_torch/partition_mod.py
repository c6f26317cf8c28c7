"""In-memory halo partitioning (counterpart of ``dgl_tpu/partition_mod.py``;
reference ``python/dgl/partition.py:139`` ``partition_graph_with_halo``,
``:400`` ``metis_partition``).

These return the partitions' subgraphs, on the graph's device; the
per-part files are ``distributed.partition.partition_graph``'s.
"""
from __future__ import annotations

import numpy as np

from .base import DGLError
from .distributed.partition import (_put, _relabel, _with_halo,
                                    metis_partition_assignment)
from .graph import Graph, _asnumpy

__all__ = [
    "partition_graph_with_halo",
    "metis_partition",
    "reshuffle_graph",
]


def reshuffle_graph(g: Graph, node_part):
    """Relabel nodes so each partition owns a contiguous ID range
    (reference ``partition.py:97`` ``reshuffle_graph``); the original IDs
    are stored as ``ndata['orig_id']`` / ``edata['orig_id']`` (int64) and
    edges come sorted by their new destination. Returns the graph and the
    relabelled ``node_part`` (host)."""
    from .convert import graph

    node_part = _asnumpy(node_part)
    n = g.num_nodes()
    order, new_of_old = _relabel(node_part)
    src, dst = g._relation(None).host_edges()
    # edges sorted by new dst id: inner edges of a part are contiguous
    eorder = np.argsort(new_of_old[dst], kind="stable")
    new_g = graph((new_of_old[src][eorder], new_of_old[dst][eorder]),
                  num_nodes=n, idtype=g.idtype, device=g.device)
    order_t, eorder_t = _put(order, g.device), _put(eorder, g.device)
    for k, v in g.ndata.items():
        new_g.ndata[k] = v[order_t]
    for k, v in g.edata.items():
        new_g.edata[k] = v[eorder_t]
    new_g.ndata["orig_id"] = order_t
    new_g.edata["orig_id"] = eorder_t
    return new_g, node_part[order]


def partition_graph_with_halo(g: Graph, node_part, extra_cached_hops: int,
                              reshuffle: bool = False):
    """Split ``g`` into per-partition subgraphs with ``extra_cached_hops``
    of HALO in-neighbors (reference ``partition.py:139``).

    Returns ``(parts, orig_nids, orig_eids)``: ``parts[p]`` carries
    ``ndata['inner_node']`` (int8), ``ndata['part_id']``, ``ndata[NID]``
    and ``edata['inner_edge']`` (int8), ``edata[EID]``; the two mappings
    are the reshuffled -> original id tensors when ``reshuffle``, else
    ``None``.
    """
    from .subgraph import node_subgraph

    node_part = _asnumpy(node_part)
    if node_part.shape[0] != g.num_nodes():
        raise DGLError("node_part must assign every node")
    orig_nids = orig_eids = None
    if reshuffle:
        g, node_part = reshuffle_graph(g, node_part)
        orig_nids, orig_eids = g.ndata["orig_id"], g.edata["orig_id"]
    num_parts = int(node_part.max()) + 1 if node_part.size else 0
    indptr, indices = g._relation(None).host_arrays("csc_indptr",
                                                    "csc_indices")
    n = g.num_nodes()
    parts = {}
    for p in range(num_parts):
        owned = np.nonzero(node_part == p)[0].astype(np.int64)
        all_nodes = _with_halo(indptr, indices, owned, extra_cached_hops, n)
        sub = node_subgraph(g, all_nodes)            # stores NID/EID
        inner = _put(np.isin(all_nodes, owned).astype(np.int8), g.device)
        sub.ndata["inner_node"] = inner
        sub.ndata["part_id"] = _put(node_part[all_nodes], g.device)
        # an edge is inner iff its dst is an inner node (reference
        # ``partition.py:199`` get_inner_edge)
        rel = sub._relation(None)
        sub.edata["inner_edge"] = inner[rel.dst[: rel.num_edges].long()]
        parts[p] = sub
    return parts, orig_nids, orig_eids


def metis_partition(g: Graph, k: int, extra_cached_hops: int = 0,
                    reshuffle: bool = False, balance_ntypes=None,
                    balance_edges: bool = False, mode: str = "k-way"):
    """METIS-class partitioning into halo subgraphs (reference
    ``partition.py:400``; assignment from the multilevel partitioner in
    ``distributed/partition.py``)."""
    if mode not in ("k-way", "recursive"):
        raise DGLError("mode must be 'k-way' or 'recursive'")
    node_part = metis_partition_assignment(
        g, k, balance_ntypes, balance_edges
    )
    parts, _, _ = partition_graph_with_halo(
        g, node_part, extra_cached_hops, reshuffle
    )
    return parts
