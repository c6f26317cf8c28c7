"""Graph construction (counterpart of ``dgl_tpu/convert.py``).

- ``graph()``: a homogeneous graph from ``(src, dst)``;
- ``heterograph()``: from a dict of canonical edge type -> ``(src, dst)``;
- ``create_block()``: a message-flow-graph block of one or more edge types;
- ``to_homogeneous()`` / ``to_heterogeneous()``: one node and edge space
  with type-id fields, and back;
- ``from_scipy()``, ``bipartite_from_scipy()``, ``from_networkx()``,
  ``bipartite_from_networkx()``, ``to_networkx()``, ``rand_graph()``,
  ``rand_bipartite()`` and ``block_to_graph()`` (``networkx`` is imported
  inside the functions that need it).

The index tensors are built on the host and placed on ``device``.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .base import EID, ETYPE, NID, NTYPE
from .graph import CanonicalEtype, Graph, Relation, _asnumpy

__all__ = ["graph", "heterograph", "create_block", "to_homogeneous",
           "to_heterogeneous", "from_scipy", "from_networkx", "rand_graph",
           "rand_bipartite", "to_networkx", "bipartite_from_scipy",
           "bipartite_from_networkx", "block_to_graph",
           "hetero_from_shared_memory"]


def _infer_num_nodes(src, dst) -> int:
    src = _asnumpy(src)
    dst = _asnumpy(dst)
    if src.size == 0:
        return 0
    return int(max(src.max(), dst.max())) + 1


def graph(data, *, num_nodes: Optional[int] = None, idtype=torch.int32,
          num_edges: Optional[int] = None, device="cuda") -> Graph:
    """Create a homogeneous graph from an edge tuple ``(src, dst)``.

    Mirrors ``dgl.graph`` (reference ``python/dgl/convert.py:32``).
    ``num_edges`` < len(src) marks trailing edges as padding.
    """
    src, dst = data
    n = num_nodes if num_nodes is not None else _infer_num_nodes(src, dst)
    rel = Relation.from_coo(src, dst, n, n, idtype=idtype,
                            num_edges=num_edges, device=device)
    return Graph({("_N", "_E", "_N"): rel}, {"_N": n})


def _max_ids(data_dict, end: int, types: int) -> Dict[str, int]:
    """Per node type, one more than the largest id at ``end`` (0: src,
    1: dst) of the edge lists, 0 for a type whose lists are empty."""
    counts: Dict[str, int] = {}
    for cet, pair in data_dict.items():
        ids = _asnumpy(pair[end])
        nt = cet[types]
        counts[nt] = max(counts.get(nt, 0),
                         int(ids.max()) + 1 if ids.size else 0)
    return counts


def heterograph(data_dict: Dict[CanonicalEtype, Tuple],
                num_nodes_dict: Optional[Dict[str, int]] = None,
                idtype=torch.int32, device="cuda") -> Graph:
    """Create a heterogeneous graph (reference ``convert.py:208``;
    ``dgl_tpu/convert.py:63``). Without ``num_nodes_dict`` each type's
    count is one more than its largest id at either end."""
    if num_nodes_dict is None:
        num_nodes_dict = _max_ids(data_dict, 0, 0)
        for nt, n in _max_ids(data_dict, 1, 2).items():
            num_nodes_dict[nt] = max(num_nodes_dict.get(nt, 0), n)
    rels = {tuple(cet): Relation.from_coo(
        src, dst, num_nodes_dict[cet[0]], num_nodes_dict[cet[2]],
        idtype=idtype, device=device)
        for cet, (src, dst) in data_dict.items()}
    return Graph(rels, dict(num_nodes_dict))


def create_block(data_dict, num_src_nodes=None, num_dst_nodes=None,
                 idtype=torch.int32, num_edges=None, device="cuda") -> Graph:
    """Create a message-flow-graph block (reference
    ``python/dgl/convert.py:389``; ``dgl_tpu/convert.py:97``).

    ``data_dict`` is a ``(src, dst)`` pair (one node and edge type) or a
    dict of canonical edge type -> pair, whose source and destination
    types may differ. The counts are ints with the pair and dicts keyed
    by node type (``num_edges`` by canonical edge type) with the dict;
    without them they are inferred from the ids.
    """
    if not isinstance(data_dict, dict):
        data_dict = {("_N", "_E", "_N"): data_dict}
        if num_src_nodes is not None and not isinstance(num_src_nodes, dict):
            num_src_nodes = {"_N": int(num_src_nodes)}
        if num_dst_nodes is not None and not isinstance(num_dst_nodes, dict):
            num_dst_nodes = {"_N": int(num_dst_nodes)}
        if num_edges is not None and not isinstance(num_edges, dict):
            num_edges = {("_N", "_E", "_N"): int(num_edges)}
    if num_src_nodes is None:
        num_src_nodes = _max_ids(data_dict, 0, 0)
    if num_dst_nodes is None:
        num_dst_nodes = _max_ids(data_dict, 1, 2)
    rels = {}
    for cet, (src, dst) in data_dict.items():
        cet = tuple(cet)
        ne = None if num_edges is None else num_edges.get(cet)
        rels[cet] = Relation.from_coo(
            src, dst, int(num_src_nodes[cet[0]]), int(num_dst_nodes[cet[2]]),
            idtype=idtype, num_edges=ne, device=device)
    return Graph(rels, {k: int(v) for k, v in num_src_nodes.items()},
                 {k: int(v) for k, v in num_dst_nodes.items()}, is_block=True)


def to_homogeneous(g: Graph, ndata=None, edata=None) -> Graph:
    """One node and edge space (reference ``convert.py:672``;
    ``dgl_tpu/convert.py:189-232``).

    Node ids are offset by type in ``g.ntypes`` order, edges concatenated
    in ``g.canonical_etypes`` order (real edges only). Adds the int64
    fields ``NTYPE``/``NID`` (type id, id within the type) to the nodes
    and ``ETYPE``/``EID`` to the edges, and concatenates the ``ndata`` and
    ``edata`` fields named. On ``g``'s device."""
    ntypes = g.ntypes
    offsets, total = {}, 0
    for nt in ntypes:
        offsets[nt] = total
        total += g.num_nodes(nt)
    srcs, dsts, etype_ids, eids = [], [], [], []
    for i, cet in enumerate(g.canonical_etypes):
        rel = g._relations[cet]
        E = rel.num_edges
        src, dst = rel.host_arrays("src", "dst")
        srcs.append(src[:E].astype(np.int64) + offsets[cet[0]])
        dsts.append(dst[:E].astype(np.int64) + offsets[cet[2]])
        etype_ids.append(np.full(E, i, np.int64))
        eids.append(np.arange(E, dtype=np.int64))

    def cat(parts):
        return np.concatenate(parts) if parts else np.zeros(0, np.int64)

    dev = g.device
    homo = graph((cat(srcs), cat(dsts)), num_nodes=total, idtype=g.idtype,
                 device=dev)

    def put(a):
        return torch.from_numpy(a).to(dev)

    homo.ndata[NTYPE] = put(cat([np.full(g.num_nodes(nt), i, np.int64)
                                 for i, nt in enumerate(ntypes)]))
    homo.ndata[NID] = put(cat([np.arange(g.num_nodes(nt), dtype=np.int64)
                               for nt in ntypes]))
    homo.edata[ETYPE] = put(cat(etype_ids))
    homo.edata[EID] = put(cat(eids))
    for key in ndata or ():
        homo.ndata[key] = torch.cat([g._node_frames[nt][key]
                                     for nt in ntypes])
    for key in edata or ():
        homo.edata[key] = torch.cat([g._edge_frames[cet][key]
                                     for cet in g.canonical_etypes])
    return homo


def to_heterogeneous(g: Graph, ntypes, etypes, ntype_field=NTYPE,
                     etype_field=ETYPE) -> Graph:
    """Split a homogeneous graph back into types (reference
    ``convert.py:892``; ``dgl_tpu/convert.py:235``): node type ``i`` of
    ``ntypes`` gets the nodes whose ``ntype_field`` is ``i`` in id order,
    and edge type ``j`` of ``etypes`` the edges whose ``etype_field`` is
    ``j``, its endpoint types read from its first edge. An edge type
    without edges is left out."""
    ntype_ids = _asnumpy(g.ndata[ntype_field])
    etype_ids = _asnumpy(g.edata[etype_field])
    E = g.num_edges()
    src, dst = g._relation().host_arrays("src", "dst")
    src, dst = src[:E], dst[:E]
    local_ids = np.zeros(g.num_nodes(), dtype=np.int64)
    num_nodes_dict = {}
    for i, nt in enumerate(ntypes):
        mask = ntype_ids == i
        local_ids[mask] = np.arange(int(mask.sum()))
        num_nodes_dict[nt] = int(mask.sum())
    data_dict = {}
    for j, et in enumerate(etypes):
        mask = etype_ids[:E] == j
        if not mask.any():
            continue
        s, d = src[mask], dst[mask]
        st = ntypes[int(ntype_ids[s[0]])]
        dt = ntypes[int(ntype_ids[d[0]])]
        data_dict[(st, et, dt)] = (local_ids[s], local_ids[d])
    return heterograph(data_dict, num_nodes_dict, idtype=g.idtype,
                       device=g.device)


def from_scipy(sp_mat, idtype=torch.int32, eweight_name=None,
               device="cuda") -> Graph:
    """A graph from a scipy sparse matrix's COO entries (reference
    ``convert.py:1149``): ``max(shape)`` nodes, the values as edge feature
    ``eweight_name``."""
    coo = sp_mat.tocoo()
    g = graph((coo.row.astype(np.int64), coo.col.astype(np.int64)),
              num_nodes=max(coo.shape[0], coo.shape[1]), idtype=idtype,
              device=device)
    if eweight_name is not None:
        g.edata[eweight_name] = torch.from_numpy(
            np.ascontiguousarray(coo.data)).to(device)
    return g


def from_networkx(nx_graph, node_attrs=None, edge_attrs=None,
                  idtype=torch.int32, device="cuda") -> Graph:
    """A graph from a networkx graph, nodes numbered in its node order
    (reference ``convert.py:1387``); an undirected graph gives both
    directions."""
    if not nx_graph.is_directed():
        nx_graph = nx_graph.to_directed()
    nodes = list(nx_graph.nodes())
    relabel = {n: i for i, n in enumerate(nodes)}
    src = np.array([relabel[u] for u, _ in nx_graph.edges()], dtype=np.int64)
    dst = np.array([relabel[v] for _, v in nx_graph.edges()], dtype=np.int64)
    g = graph((src, dst), num_nodes=len(nodes), idtype=idtype, device=device)
    for attr in node_attrs or ():
        g.ndata[attr] = torch.from_numpy(np.stack(
            [np.asarray(nx_graph.nodes[n][attr]) for n in nodes])).to(device)
    for attr in edge_attrs or ():
        g.edata[attr] = torch.from_numpy(np.stack(
            [np.asarray(nx_graph.edges[e][attr])
             for e in nx_graph.edges()])).to(device)
    return g


def rand_graph(num_nodes: int, num_edges: int, idtype=torch.int32,
               seed=None, device="cuda") -> Graph:
    """Uniform random graph: sources, then destinations, drawn from
    ``np.random.default_rng(seed)`` (the JAX package's draws, so equal seeds
    give equal graphs)."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, num_nodes, size=num_edges)
    dst = rng.integers(0, num_nodes, size=num_edges)
    return graph((src, dst), num_nodes=num_nodes, idtype=idtype,
                 device=device)


def rand_bipartite(utype, etype, vtype, num_src, num_dst, num_edges,
                   idtype=torch.int32, seed=None, device="cuda") -> Graph:
    """Uniform random bipartite graph, drawn as ``rand_graph`` draws."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, num_src, size=num_edges)
    dst = rng.integers(0, num_dst, size=num_edges)
    return heterograph({(utype, etype, vtype): (src, dst)},
                       {utype: num_src, vtype: num_dst}, idtype=idtype,
                       device=device)


def to_networkx(g: Graph, node_attrs=None, edge_attrs=None):
    """Module-level form of ``Graph.to_networkx``."""
    return g.to_networkx(node_attrs=node_attrs, edge_attrs=edge_attrs)


def bipartite_from_scipy(sp_mat, utype, etype, vtype, eweight_name=None,
                         idtype=torch.int32, device="cuda") -> Graph:
    """A bipartite graph from a scipy sparse matrix (rows ``utype``,
    columns ``vtype``)."""
    coo = sp_mat.tocoo()
    cet = (utype, etype, vtype)
    g = heterograph({cet: (np.asarray(coo.row), np.asarray(coo.col))},
                    {utype: coo.shape[0], vtype: coo.shape[1]},
                    idtype=idtype, device=device)
    if eweight_name is not None:
        w = np.zeros(g._relations[cet].num_edges_padded, coo.data.dtype)
        w[: coo.data.shape[0]] = coo.data
        g._edge_frames.setdefault(cet, {})[eweight_name] = (
            torch.from_numpy(w).to(device))
    return g


def bipartite_from_networkx(nx_graph, utype, etype, vtype,
                            idtype=torch.int32, device="cuda") -> Graph:
    """A bipartite graph from a networkx bipartite graph: nodes with
    ``bipartite == 0`` become ``utype`` rows, in sorted order."""
    top = sorted(n for n, d in nx_graph.nodes(data=True)
                 if d.get("bipartite") == 0)
    bottom = sorted(n for n, d in nx_graph.nodes(data=True)
                    if d.get("bipartite") == 1)
    uid = {n: i for i, n in enumerate(top)}
    vid = {n: i for i, n in enumerate(bottom)}
    src, dst = [], []
    for a, b in nx_graph.edges():
        if a in uid and b in vid:
            src.append(uid[a])
            dst.append(vid[b])
        elif b in uid and a in vid:
            src.append(uid[b])
            dst.append(vid[a])
    return heterograph({(utype, etype, vtype): (np.asarray(src, np.int64),
                                                np.asarray(dst, np.int64))},
                       {utype: len(top), vtype: len(bottom)}, idtype=idtype,
                       device=device)


def block_to_graph(block: Graph) -> Graph:
    """A block as a plain bipartite graph whose source and destination
    types get ``_src``/``_dst`` suffixes, frames carried, on the block's
    device."""
    data_dict, nn = {}, {}
    for (st, et, dt), rel in block._relations.items():
        data_dict[(f"{st}_src", et, f"{dt}_dst")] = rel.host_edges()
        nn[f"{st}_src"] = rel.num_src
        nn[f"{dt}_dst"] = rel.num_dst
    g = heterograph(data_dict, nn, idtype=block.idtype, device=block.device)
    for nt, frame in block._node_frames.items():
        g._node_frames.setdefault(f"{nt}_src", {}).update(frame)
    for nt, frame in block._dst_frames.items():
        g._node_frames.setdefault(f"{nt}_dst", {}).update(frame)
    return g


def hetero_from_shared_memory(name: str, device="cuda") -> Graph:
    """Attach a (hetero)graph that :meth:`Graph.shared_memory` of either
    package published under ``name`` (reference ``convert.py``
    ``hetero_from_shared_memory``): its structure and frames, built on
    ``device``. The block stays published."""
    import io
    import json
    from multiprocessing import shared_memory

    from .data.serialize import _unflatten_graph

    shm = shared_memory.SharedMemory(name=name)
    try:
        size = int.from_bytes(bytes(shm.buf[:8]), "little")
        raw = bytes(shm.buf[8:8 + size])
    finally:
        shm.close()
    with np.load(io.BytesIO(raw), allow_pickle=False) as z:
        meta = json.loads(bytes(z["__meta__"].tobytes()).decode("utf-8"))
        arrays = {k: z[k] for k in z.files}
    return _unflatten_graph(meta["graphs"][0], arrays, device)
