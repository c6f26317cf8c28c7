"""Graph transforms (counterpart of ``dgl_tpu/transforms/functional.py``).

Structure changes run on the host with numpy (scipy where the reference
uses it) and return new graphs on the input graph's device, with the
reference's edge order: the structural transforms (``add_self_loop``
through ``update_graph_structure``), the frame casts, the relation algebra
(``metapath_reachable_graph``, ``adj_product_graph``, ``adj_sum_graph``,
``to_levi``, ``sort_csr_by_tag``, ``sort_csc_by_tag``), the orders
(``reorder_graph``, ``rcmk_perm``, ``reorder_for_spmm``), the positional
encodings (``random_walk_pe``, ``lap_pe``, ``svd_pe``,
``laplacian_lambda_max``), the paths (``shortest_dist``,
``double_radius_node_labeling``) and the dense diffusions (``ppr``,
``heat_kernel``): the same numpy and scipy calls as the reference, whose
eigen- and singular vectors, thresholds and ties they therefore share.

On the device, in torch: ``knn_graph`` (float32 distances, ties to the
lower index), ``segmented_knn_graph``, ``pairwise_squared_distance``,
``norm_by_dst`` and ``sign_diffusion`` (``update_all``, so a graph's hub
plan runs kernel B1). ``radius_graph`` and the segmented query ``knn`` are
host numpy. The point-cloud functions return their graphs and tensors on
``device``: by default the points' own device when they are a tensor,
else the card.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from ..base import EID, NID, DGLError
from ..graph import (Graph, Relation, _asnumpy, ragged_gather,
                     unique_first_occurrence, with_dense_plans)

__all__ = [
    "add_self_loop", "remove_self_loop", "add_reverse_edges", "add_edges",
    "remove_edges", "add_nodes", "remove_nodes", "to_bidirected",
    "to_simple", "to_simple_graph", "reverse", "khop_adj", "khop_graph",
    "compact_graphs", "to_block", "line_graph", "norm_by_dst",
    "is_bidirected", "update_graph_structure", "to_float", "to_double",
    "to_half", "to_bfloat16", "reorder_graph", "reorder_for_spmm",
    "pairwise_squared_distance", "knn_graph", "segmented_knn_graph",
    "radius_graph", "knn", "laplacian_lambda_max", "random_walk_pe",
    "lap_pe", "laplacian_pe", "svd_pe", "shortest_dist",
    "double_radius_node_labeling", "ppr", "heat_kernel", "sign_diffusion",
    "metapath_reachable_graph", "adj_product_graph", "adj_sum_graph",
    "to_levi", "sort_csr_by_tag", "sort_csc_by_tag", "rcmk_perm",
    "metis_perm",
]


def _put(a, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _rebuild(g: Graph, cet, new_src, new_dst, *, num_src=None,
             num_dst=None, edge_map: Optional[np.ndarray] = None,
             edge_defaults: Optional[Dict] = None) -> Graph:
    """Replace one relation's edges, with no plan; keep the other
    relations and the node frames; map the relation's edge frames.

    ``edge_map[i]`` is the old id of new edge ``i``, or -1 for a fresh
    edge, whose features are 0 or ``edge_defaults[key]``. Without
    ``edge_map`` the relation's edge frames are dropped."""
    st, _, dt = cet
    ns = g.num_src_nodes(st) if num_src is None else num_src
    nd = g.num_dst_nodes(dt) if num_dst is None else num_dst
    rels = dict(g._relations)
    rels[cet] = Relation.from_coo(new_src, new_dst, ns, nd, idtype=g.idtype,
                                  device=g.device)
    nsrc = dict(g._num_src_nodes)
    ndst = dict(g._num_dst_nodes)
    nsrc[st] = ns
    ndst[dt] = nd
    if not g.is_block:
        nsrc[dt] = nd
        ndst[st] = ns if st in ndst else ndst.get(st, ns)
        if st == dt:
            nsrc[st] = ns
    out = Graph(rels, nsrc, ndst, is_block=g.is_block)
    for nt, f in g._node_frames.items():
        out._node_frames[nt] = dict(f)
    if g.is_block:
        for nt, f in g._dst_frames.items():
            out._dst_frames[nt] = dict(f)
    for c, f in g._edge_frames.items():
        if c != cet:
            out._edge_frames[c] = dict(f)
    if edge_map is not None:
        fresh = edge_map < 0
        safe = _put(np.where(fresh, 0, edge_map), g.device)
        mask = _put(fresh, g.device)
        newf = {}
        for k, v in g._edge_frames.get(cet, {}).items():
            nv = v[safe]
            if fresh.any():
                m = mask.reshape((-1,) + (1,) * (nv.dim() - 1))
                if edge_defaults and k in edge_defaults:
                    fill = torch.as_tensor(edge_defaults[k],
                                           device=nv.device).to(nv.dtype)
                else:
                    fill = nv.new_zeros(())
                nv = torch.where(m, fill, nv)
            newf[k] = nv
        out._edge_frames[cet] = newf
    return out


def add_self_loop(g: Graph, edge_feat_names=None, fill_data=1.0,
                  etype=None) -> Graph:
    """A self-loop appended for every node, after the edges (reference
    ``add_self_loop``). Existing self-loops stay; the new edges' features
    are ``fill_data`` (for ``edge_feat_names``, default all)."""
    cet = g.to_canonical_etype(etype)
    if cet[0] != cet[2]:
        raise DGLError("add_self_loop requires src and dst type to match")
    rel = g._relations[cet]
    n = g.num_nodes(cet[0])
    src, dst = rel.host_edges()
    loops = np.arange(n, dtype=src.dtype)
    edge_map = np.concatenate([np.arange(rel.num_edges, dtype=np.int64),
                               np.full(n, -1, np.int64)])
    defaults = None
    if fill_data is not None:
        keys = edge_feat_names
        if keys is None:
            keys = list(g._edge_frames.get(cet, {}))
        defaults = {k: fill_data for k in keys}
    return _rebuild(g, cet, np.concatenate([src, loops]),
                    np.concatenate([dst, loops]), edge_map=edge_map,
                    edge_defaults=defaults)


def remove_self_loop(g: Graph, etype=None) -> Graph:
    """The graph without its self-loops, the other edges in their order."""
    cet = g.to_canonical_etype(etype)
    src, dst = g._relations[cet].host_edges()
    keep = np.nonzero(src != dst)[0]
    return _rebuild(g, cet, src[keep], dst[keep],
                    edge_map=keep.astype(np.int64))


def add_reverse_edges(g: Graph, readonly=None, copy_ndata=True,
                      copy_edata=False, etype=None) -> Graph:
    """The reversed edges appended after the edges; their features are the
    originals' with ``copy_edata``, else 0."""
    cet = g.to_canonical_etype(etype)
    if cet[0] != cet[2]:
        raise DGLError("add_reverse_edges requires a homogeneous relation")
    rel = g._relations[cet]
    src, dst = rel.host_edges()
    e = np.arange(rel.num_edges, dtype=np.int64)
    edge_map = np.concatenate(
        [e, e if copy_edata else np.full(rel.num_edges, -1, np.int64)])
    return _rebuild(g, cet, np.concatenate([src, dst]),
                    np.concatenate([dst, src]), edge_map=edge_map)


def add_edges(g: Graph, u, v, data=None, etype=None) -> Graph:
    """A new graph with the edges ``(u, v)`` appended, growing the node
    counts to cover them (reference ``add_edges``, functional here)."""
    cet = g.to_canonical_etype(etype)
    rel = g._relations[cet]
    u = np.atleast_1d(_asnumpy(u)).astype(np.int64)
    v = np.atleast_1d(_asnumpy(v)).astype(np.int64)
    src, dst = rel.host_edges()
    ns = max(g.num_src_nodes(cet[0]), int(u.max()) + 1 if u.size else 0)
    nd = max(g.num_dst_nodes(cet[2]), int(v.max()) + 1 if v.size else 0)
    if cet[0] == cet[2]:
        ns = nd = max(ns, nd)
    edge_map = np.concatenate([np.arange(rel.num_edges, dtype=np.int64),
                               np.full(u.size, -1, np.int64)])
    out = _rebuild(g, cet, np.concatenate([src, u]),
                   np.concatenate([dst, v]), num_src=ns, num_dst=nd,
                   edge_map=edge_map)
    if data:
        f = out._edge_frames.setdefault(cet, {})
        for k, val in data.items():
            val = torch.as_tensor(_asnumpy(val), device=g.device)
            base = (f[k][: rel.num_edges] if k in f else val.new_zeros(
                (rel.num_edges,) + tuple(val.shape[1:])))
            f[k] = torch.cat([base, val])
    return out


def remove_edges(g: Graph, eids, etype=None, store_ids: bool = False):
    """A new graph without the edges ``eids``, the rest in their order
    (their old ids in ``edata[EID]`` with ``store_ids``)."""
    cet = g.to_canonical_etype(etype)
    rel = g._relations[cet]
    keep = np.setdiff1d(np.arange(rel.num_edges, dtype=np.int64),
                        np.atleast_1d(_asnumpy(eids)).astype(np.int64))
    src, dst = rel.host_arrays("src", "dst")
    out = _rebuild(g, cet, src[keep], dst[keep], edge_map=keep)
    if store_ids:
        out._edge_frames.setdefault(cet, {})[EID] = _put(keep, g.device)
    return out


def add_nodes(g: Graph, num: int, data=None, ntype=None) -> Graph:
    """A new graph with ``num`` more nodes of a type; their features are
    ``data``'s, the type's initializer's or 0."""
    nt = ntype or (g.ntypes[0] if len(g.ntypes) == 1 else None)
    if nt is None:
        raise DGLError("ntype required")
    rels = dict(g._relations)
    nsrc = dict(g._num_src_nodes)
    ndst = dict(g._num_dst_nodes)
    old_n = nsrc[nt]
    nsrc[nt] = old_n + num
    if nt in ndst:
        ndst[nt] = ndst[nt] + num
    # the relations touching nt are rebuilt for their longer indptr
    for cet, rel in g._relations.items():
        if cet[0] == nt or cet[2] == nt:
            src, dst = rel.host_edges()
            rels[cet] = Relation.from_coo(src, dst, nsrc[cet[0]],
                                          ndst[cet[2]], idtype=g.idtype,
                                          device=g.device)
    out = Graph(rels, nsrc, ndst, is_block=g.is_block)
    for t, f in g._node_frames.items():
        if t != nt:
            out._node_frames[t] = dict(f)
            continue
        newf = {}
        for k, v in f.items():
            init = g._get_initializer("node", k, nt)
            if data and k in data:
                pad = torch.as_tensor(_asnumpy(data[k]),
                                      device=v.device).to(v.dtype)
            elif init is not None:
                pad = torch.as_tensor(init((num,) + tuple(v.shape[1:]),
                                           v.dtype), device=v.device)
            else:
                pad = v.new_zeros((num,) + tuple(v.shape[1:]))
            newf[k] = torch.cat([v, pad])
        out._node_frames[t] = newf
    if data:
        f = out._node_frames.setdefault(nt, {})
        for k, v in data.items():
            if k not in f:
                v = torch.as_tensor(_asnumpy(v), device=g.device)
                f[k] = torch.cat([v.new_zeros((old_n,) + tuple(v.shape[1:])),
                                  v])
    for c, f in g._edge_frames.items():
        out._edge_frames[c] = dict(f)
    return out


def remove_nodes(g: Graph, nids, ntype=None, store_ids: bool = False):
    """A new graph without the nodes ``nids`` and their edges."""
    from ..subgraph import node_subgraph

    nt = ntype or (g.ntypes[0] if len(g.ntypes) == 1 else None)
    if nt is None:
        raise DGLError("ntype required for heterographs")
    keep = np.setdiff1d(np.arange(g.num_nodes(nt), dtype=np.int64),
                        np.atleast_1d(_asnumpy(nids)).astype(np.int64))
    nodes = {t: (keep if t == nt
                 else np.arange(g.num_nodes(t), dtype=np.int64))
             for t in g.ntypes}
    if len(g.ntypes) == 1:
        nodes = keep
    return node_subgraph(g, nodes, store_ids=store_ids)


def to_bidirected(g: Graph, copy_ndata: bool = False) -> Graph:
    """The simple symmetric graph: (u, v) and (v, u) for every edge, each
    pair once, in lexicographic order. Edge frames are dropped, and node
    frames unless ``copy_ndata``."""
    cet = g.to_canonical_etype(None)
    src, dst = g._relations[cet].host_edges()
    pairs = np.unique(np.stack([np.concatenate([src, dst]),
                                np.concatenate([dst, src])], axis=1), axis=0)
    out = _rebuild(g, cet, pairs[:, 0], pairs[:, 1])
    if not copy_ndata:
        out._node_frames = {}
        out._dst_frames = out._node_frames
    out._edge_frames = {}
    return out


def to_simple(g: Graph, return_counts: Optional[str] = "count",
              writeback_mapping: bool = False, copy_ndata: bool = True,
              copy_edata: bool = False):
    """Parallel edges merged into one, in lexicographic (src, dst) order
    (reference C++ ``to_simple.cc``): the multiplicities in
    ``edata[return_counts]``, and with ``writeback_mapping`` each old
    edge's new id. Edge frames are not carried (``copy_edata`` is accepted
    and, as in the reference, ignored)."""
    out_rels, counts, wb = {}, {}, {}
    for cet in g.canonical_etypes:
        src, dst = g._relations[cet].host_edges()
        uniq, inverse, cnt = np.unique(np.stack([src, dst], axis=1), axis=0,
                                       return_inverse=True,
                                       return_counts=True)
        out_rels[cet] = Relation.from_coo(
            uniq[:, 0], uniq[:, 1], g.num_src_nodes(cet[0]),
            g.num_dst_nodes(cet[2]), idtype=g.idtype, device=g.device)
        counts[cet] = _put(cnt.astype(np.int64), g.device)
        wb[cet] = _put(inverse.reshape(-1).astype(np.int64), g.device)
    out = Graph(out_rels, dict(g._num_src_nodes), dict(g._num_dst_nodes))
    if copy_ndata:
        for nt, f in g._node_frames.items():
            out._node_frames[nt] = dict(f)
    if return_counts:
        for cet in g.canonical_etypes:
            out._edge_frames.setdefault(cet, {})[return_counts] = counts[cet]
    if writeback_mapping:
        if len(g.canonical_etypes) == 1:
            return out, wb[g.canonical_etypes[0]]
        return out, wb
    return out


def to_simple_graph(g: Graph) -> Graph:
    """Deprecated reference alias of ``to_simple``."""
    return to_simple(g)


def reverse(g: Graph, copy_ndata=True, copy_edata=True) -> Graph:
    """Every edge reversed (``Graph.reverse``)."""
    return g.reverse(copy_ndata=copy_ndata, copy_edata=copy_edata)


def khop_graph(g: Graph, k: int) -> Graph:
    """Edges joining the k-hop pairs, one per path (scipy's ``A ** k``, in
    its CSR order); node frames kept, edge frames dropped."""
    import scipy.sparse as sp

    cet = g.to_canonical_etype(None)
    n = g.num_nodes()
    src, dst = g._relations[cet].host_edges()
    adj = sp.csr_matrix((np.ones(src.size), (src, dst)), shape=(n, n))
    coo = (adj ** k).tocoo()
    reps = coo.data.astype(np.int64)
    return _rebuild(g, cet, np.repeat(coo.row, reps),
                    np.repeat(coo.col, reps))


def khop_adj(g: Graph, k: int) -> torch.Tensor:
    """The dense k-th power of the adjacency (f32, on the graph's
    device)."""
    n = g.num_nodes()
    src, dst = g._relation(None).host_edges()
    a = np.zeros((n, n), np.float32)
    np.add.at(a, (src, dst), 1.0)
    return _put(np.linalg.matrix_power(a, k), g.device)


def compact_graphs(graphs, always_preserve=None):
    """The graphs without the nodes that no edge of any of them touches,
    relabelled alike (reference C++ ``compact.cc``)."""
    from ..subgraph import node_subgraph

    single = isinstance(graphs, Graph)
    if single:
        graphs = [graphs]
    g0 = graphs[0]
    used = {nt: np.zeros(g0.num_nodes(nt), dtype=bool) for nt in g0.ntypes}
    if always_preserve is not None:
        if not isinstance(always_preserve, Mapping):
            always_preserve = {g0.ntypes[0]: always_preserve}
        for nt, ids in always_preserve.items():
            used[nt][_asnumpy(ids)] = True
    for g in graphs:
        for cet in g.canonical_etypes:
            src, dst = g._relations[cet].host_edges()
            used[cet[0]][src] = True
            used[cet[2]][dst] = True
    keep = {nt: np.nonzero(m)[0] for nt, m in used.items()}
    outs = [node_subgraph(g, keep) for g in graphs]
    return outs[0] if single else outs


def to_block(g: Graph, dst_nodes=None, include_dst_in_src: bool = True,
             src_nodes=None) -> Graph:
    """A frontier graph as a message-flow-graph block (reference
    ``to_block.py`` / C++ ``to_block.cc:136``): the destination nodes
    first in the source space (``include_dst_in_src``), then the other
    sources in first-occurrence order; ``NID``/``EID`` and the frames
    carried over."""
    if dst_nodes is None:
        dst_nodes = {}
        for cet in g.canonical_etypes:
            d = np.unique(g._relations[cet].host_edges()[1])
            prev = dst_nodes.get(cet[2])
            dst_nodes[cet[2]] = d if prev is None else np.union1d(prev, d)
    elif not isinstance(dst_nodes, Mapping):
        dst_nodes = {g.ntypes[0]: _asnumpy(dst_nodes)}
    dst_nodes = {nt: _asnumpy(v).astype(np.int64) for nt, v in dst_nodes.items()}
    empty = np.zeros(0, np.int64)
    kept = {}
    for cet in g.canonical_etypes:
        s, d = g._relations[cet].host_edges()
        new_d = dst_slots(d, dst_nodes.get(cet[2], empty),
                          g.num_nodes(cet[2]))
        keep = np.nonzero(new_d >= 0)[0]
        kept[cet] = (s[keep], new_d[keep], keep)
    return block_from_edges(g, dst_nodes, kept, include_dst_in_src)


def dst_slots(d: np.ndarray, dst_arr: np.ndarray, num_dst: int) -> np.ndarray:
    """Each edge's destination's position in ``dst_arr`` (its first
    occurrence there), or -1 where ``dst_arr`` lacks it: a dense lookup
    over the ``num_dst`` node ids."""
    uniq, first = np.unique(dst_arr, return_index=True)
    ok = (uniq >= 0) & (uniq < num_dst)
    slot = np.full(num_dst, -1, np.int64)
    slot[uniq[ok]] = first[ok]
    return slot[d]


def block_from_edges(g: Graph, dst_nodes: Mapping, kept: Mapping,
                     include_dst_in_src: bool = True,
                     own_eids: bool = False) -> Graph:
    """The block of ``to_block`` from its edges: ``kept[cet]`` holds a
    canonical edge type's (source node ids of ``g``, destination positions
    in ``dst_nodes[cet[2]]``, edge ids of ``g``). The destination nodes
    come first in the source space (``include_dst_in_src``), then the
    other sources in first-occurrence order; ``NID``/``EID`` and ``g``'s
    frames carried over. With ``own_eids`` the block's ``EID`` is the
    given edge ids even where ``g`` has an ``EID`` frame."""
    from .. import convert

    empty = np.zeros(0, np.int64)
    # source slots: one first-occurrence unique a node type over the
    # destination prefix and the kept sources in edge-type order
    src_ids_of, seg_of = {}, {}
    for nt in g.ntypes:
        prefix = dst_nodes.get(nt, empty) if include_dst_in_src else empty
        parts, spans, at = [prefix], {}, prefix.shape[0]
        for cet in g.canonical_etypes:
            if cet[0] != nt:
                continue
            s_kept = kept[cet][0]
            spans[cet] = (at, at + s_kept.shape[0])
            parts.append(s_kept.astype(np.int64))
            at += s_kept.shape[0]
        uniq, inv = unique_first_occurrence(np.concatenate(parts))
        if prefix.size and not np.array_equal(uniq[: prefix.shape[0]],
                                              prefix):
            raise DGLError("to_block requires unique dst_nodes per type")
        src_ids_of[nt] = uniq
        seg_of[nt] = {cet: inv[a:b] for cet, (a, b) in spans.items()}

    data_dict = {cet: (seg_of[cet[0]][cet], new_d)
                 for cet, (_, new_d, _) in kept.items()}
    block = convert.create_block(
        data_dict, num_src_nodes={nt: len(src_ids_of[nt]) for nt in g.ntypes},
        num_dst_nodes={nt: int(dst_nodes.get(nt, empty).shape[0])
                       for nt in g.ntypes},
        idtype=g.idtype, device=g.device)
    for nt in g.ntypes:
        sids = _put(src_ids_of[nt].astype(np.int64), g.device)
        dids = _put(dst_nodes.get(nt, empty), g.device)
        sf = block._node_frames.setdefault(nt, {})
        df = block._dst_frames.setdefault(nt, {})
        sf[NID], df[NID] = sids, dids
        for k, v in g._node_frames.get(nt, {}).items():
            sf[k], df[k] = v[sids], v[dids]
    for cet, (_, _, eids) in kept.items():
        eids = _put(eids, g.device)
        ef = block._edge_frames.setdefault(cet, {})
        ef[EID] = eids
        for k, v in g._edge_frames.get(cet, {}).items():
            if not (own_eids and k == EID):
                ef[k] = v[eids]
    return block


def line_graph(g: Graph, backtracking: bool = True,
               shared: bool = False) -> Graph:
    """The line graph (reference C++ ``line_graph.cc``): a node per edge,
    and an edge i -> j wherever ``dst[i] == src[j]``, without the reverse
    of i unless ``backtracking``; edges by i, then by j in CSR order."""
    from .. import convert

    rel = g._relation(None)
    E = rel.num_edges
    src, dst = rel.host_edges()
    indptr, eids = rel.host_arrays("csr_indptr", "csr_eids")
    ld = ragged_gather(indptr, eids, dst.astype(np.int64)).astype(np.int64)
    ls = np.repeat(np.arange(E, dtype=np.int64),
                   (indptr[dst + 1] - indptr[dst]).astype(np.int64))
    if not backtracking:
        keep = ~((dst[ld] == src[ls]) & (src[ld] == dst[ls]))
        ls, ld = ls[keep], ld[keep]
    return convert.graph((ls, ld), num_nodes=E, device=g.device)


def norm_by_dst(g: Graph, etype=None) -> torch.Tensor:
    """1 / in-degree of each edge's destination (at least 1); a padded
    edge reads the last node's, as in the reference."""
    rel = g._relation(etype)
    inv = 1.0 / torch.clamp(rel.in_degrees().float(), min=1.0)
    return inv[rel.dst.long().clamp(max=max(rel.num_dst - 1, 0))]


def is_bidirected(g: Graph) -> bool:
    """Whether every edge (u, v) has a matching (v, u), with multiplicity
    (padded edges included, as in the reference)."""
    src, dst = g._relation(None).host_arrays("src", "dst")
    n = g.num_nodes()
    fwd = np.sort(src.astype(np.int64) * n + dst)
    bwd = np.sort(dst.astype(np.int64) * n + src)
    return bool(np.array_equal(fwd, bwd))


def update_graph_structure(g: Graph, data_dict,
                           copy_edata: bool = True) -> Graph:
    """A graph of new edges over the same nodes, node frames carried, and
    edge frames of the edge types it keeps with ``copy_edata``."""
    from .. import convert

    new_g = convert.heterograph(
        data_dict, num_nodes_dict={nt: g.num_nodes(nt) for nt in g.ntypes},
        idtype=g.idtype, device=g.device)
    for nt in g.ntypes:
        new_g._node_frames.setdefault(nt, {}).update(
            g._node_frames.get(nt, {}))
    if copy_edata:
        for cet in g.canonical_etypes:
            if cet in new_g._relations:
                new_g._edge_frames.setdefault(cet, {}).update(
                    g._edge_frames.get(cet, {}))
    return new_g


def _cast_frames(g: Graph, float_dtype) -> Graph:
    out = g.local_var()
    for frames in (out._node_frames, out._edge_frames, out._dst_frames):
        for frame in frames.values():
            for key, val in list(frame.items()):
                if torch.is_tensor(val) and val.is_floating_point():
                    frame[key] = val.to(float_dtype)
    return out


def to_float(g: Graph) -> Graph:
    """Float features cast to float32."""
    return _cast_frames(g, torch.float32)


def to_double(g: Graph) -> Graph:
    """Float features cast to float64."""
    return _cast_frames(g, torch.float64)


def to_half(g: Graph) -> Graph:
    """Float features cast to float16."""
    return _cast_frames(g, torch.float16)


def to_bfloat16(g: Graph) -> Graph:
    """Float features cast to bfloat16."""
    return _cast_frames(g, torch.bfloat16)


def reorder_graph(g: Graph, node_permute_algo: str = "rcmk",
                  edge_permute_algo: str = "src", store_ids: bool = True,
                  permute_config=None) -> Graph:
    """Relabel nodes (reference ``functional.py`` ``reorder_graph``).

    ``node_permute_algo`` is ``'rcmk'`` (``rcmk_perm``), ``'metis'``
    (``metis_perm`` with ``permute_config['k']`` parts, default 8) or
    ``'custom'`` (``permute_config['nodes_perm']``): ``perm[i]`` is the
    old id of new node ``i``. Edges keep their ids and order; node
    features are carried over permuted."""
    if node_permute_algo == "rcmk":
        perm = _rcmk_host(g)
    elif node_permute_algo == "custom":
        perm = _asnumpy((permute_config or {})["nodes_perm"])
    elif node_permute_algo == "metis":
        perm = _metis_host(g, (permute_config or {}).get("k", 8))
    else:
        raise DGLError(f"Unknown node_permute_algo {node_permute_algo!r}")
    n = g.num_nodes()
    rel = g._relation(None)
    src, dst = rel.host_arrays("src", "dst")
    src, dst = src[: rel.num_edges], dst[: rel.num_edges]
    perm = np.asarray(perm, np.int64)
    new_of_old = np.empty(n, dtype=np.int64)
    new_of_old[perm] = np.arange(n)
    cet = g.to_canonical_etype(None)
    new_rel = Relation.from_coo(new_of_old[src], new_of_old[dst], n, n,
                                idtype=g.idtype, device=rel.device)
    out = Graph({cet: new_rel}, dict(g._num_src_nodes))
    for c, f in g._edge_frames.items():
        out._edge_frames[c] = {k: v[: rel.num_edges] for k, v in f.items()}
    for nt, f in g._node_frames.items():
        out._node_frames[nt] = {
            k: v[torch.from_numpy(perm).to(v.device)] for k, v in f.items()}
    if store_ids:
        out._node_frames.setdefault(g.ntypes[0], {})[NID] = (
            torch.from_numpy(perm).to(rel.device))
        out._edge_frames.setdefault(cet, {})[EID] = torch.arange(
            rel.num_edges, device=rel.device)
    return out


def reorder_for_spmm(g: Graph, num_hubs=2048, precision: str = "int8",
                     weighted: bool = False, gather_dtype: str = "bf16"):
    """Relabel nodes into the hub plan's dst-rank order and attach the plan.

    With rank order equal to id order, the shell accumulation's final
    unrank gather is the identity and the plan leaves it out. The hub set
    of the first plan is mapped through the relabel and pinned: a freshly
    chosen hub set can differ on degree ties, which would perturb the cold
    degrees and break the identity ranking.

    With ``weighted=True`` the relabelled graph also carries the weighted
    shell plan (``gather_dtype``), as ``with_spmm_plans(weighted=True)``
    attaches it.

    Returns ``(g2, perm)``: ``perm[i]`` is the original id of new node
    ``i``; node features are carried over permuted. Homogeneous graphs
    only.
    """
    from ..ops.hub_spmm import build_hub_plan
    from ..ops.shell_spmm import build_shell_plan

    rel = g._relation(None)
    h = g._auto_num_hubs(rel) if num_hubs == "auto" else int(num_hubs)
    plan = build_hub_plan(rel, h, precision)
    if plan.unrank_dst is None:  # already rank-ordered
        perm = np.arange(g.num_nodes(), dtype=np.int64)
        return g.with_spmm_plans(num_hubs=h, precision=precision,
                                 weighted=weighted,
                                 gather_dtype=gather_dtype), perm
    perm = np.argsort(plan.unrank_dst.cpu().numpy(),
                      kind="stable").astype(np.int64)
    g2 = reorder_graph(g, "custom", store_ids=False,
                       permute_config={"nodes_perm": perm})
    new_of_old = np.empty(perm.shape[0], np.int64)
    new_of_old[perm] = np.arange(perm.shape[0])
    hubs_new = new_of_old[plan.hub_ids.cpu().numpy()[: plan.num_hubs]]
    # the reference attaches with_spmm_plans' plans and then replaces the
    # hub plan with this pinned one; the pinned plan is built directly and
    # the other plans attached as with_spmm_plans would
    rel2 = g2._relation(None)
    key = g2.to_canonical_etype(None)
    rel2 = rel2.with_hub_plan(
        build_hub_plan(rel2, h, precision, hub_ids_override=hubs_new))
    if weighted:
        rel2 = rel2.with_shell_plan(build_shell_plan(rel2, gather_dtype))
    g2._relations = {key: with_dense_plans(rel2)}
    return g2, perm


# ---------------------------------------------------------------------------
# point clouds: distances, neighbour graphs
# ---------------------------------------------------------------------------


def _points_device(x, device):
    """``device``, or by default the points' own device when they are a
    tensor, else the card."""
    if device is not None:
        return torch.device(device)
    return x.device if isinstance(x, torch.Tensor) else torch.device("cuda")


def _points(x, device) -> torch.Tensor:
    return torch.as_tensor(_asnumpy(x) if not isinstance(x, torch.Tensor)
                           else x, dtype=torch.float32,
                           device=_points_device(x, device))


def pairwise_squared_distance(x, *, device=None) -> torch.Tensor:
    """(N, N) squared euclidean distances ``|x_i|² − 2 x_i·x_j + |x_j|²``
    in float32."""
    x = _points(x, device)
    sq = (x * x).sum(1)
    return sq[:, None] - 2 * (x @ x.T) + sq[None, :]


def _knn_indices(x: torch.Tensor, k: int, dist: str) -> torch.Tensor:
    """Each point's ``k`` nearest points (itself included), nearest first,
    a tie to the lower index, as the reference's ``lax.top_k`` of the
    negated distances orders them: (N, k) int64."""
    if dist == "cosine":
        xn = x / (torch.linalg.vector_norm(x, dim=1, keepdim=True) + 1e-12)
        d = -(xn @ xn.T)
    else:
        d = pairwise_squared_distance(x)
    return torch.sort(d, dim=1, stable=True).indices[:, :k]


def knn_graph(x, k: int, algorithm: str = "bruteforce",
              dist: str = "euclidean", *, device=None) -> Graph:
    """The k-nearest-neighbour graph of the points ``x`` (N, D) (reference
    ``functional.py`` ``knn_graph``): an edge from each of a point's
    ``min(k, N)`` nearest points (itself included), nearest first, to the
    point; ``dist`` is ``"euclidean"`` or ``"cosine"``."""
    from .. import convert

    x = _points(x, device)
    n = x.shape[0]
    k = min(k, n)
    src = _knn_indices(x, k, dist).reshape(-1).cpu().numpy()
    dst = np.repeat(np.arange(n), k)
    return convert.graph((src, dst), num_nodes=n, device=x.device)


def segmented_knn_graph(x, k: int, segs, dist: str = "euclidean", *,
                        device=None) -> Graph:
    """``knn_graph`` of each segment of ``segs`` points on its own, as one
    graph over all the points (reference ``segmented_knn_graph``)."""
    from .. import convert

    x = _points(x, device)
    offs = np.concatenate([[0], np.cumsum(_asnumpy(segs))]).astype(np.int64)
    srcs, dsts = [], []
    for lo, hi in zip(offs[:-1], offs[1:]):
        kk = min(k, hi - lo)
        srcs.append(_knn_indices(x[lo:hi], kk, dist).reshape(-1).cpu()
                    .numpy() + lo)
        dsts.append(np.repeat(np.arange(lo, hi), kk))
    return convert.graph((np.concatenate(srcs), np.concatenate(dsts)),
                         num_nodes=x.shape[0], device=x.device)


def radius_graph(x, r: float, dist: str = "euclidean",
                 get_distances: bool = False, *, device=None):
    """An edge ``j -> i`` wherever ``dist(i, j) <= r``, no self-loops, in
    row-major order (reference ``radius_graph``; host numpy in the points'
    dtype). With ``get_distances`` also the (E, 1) distances."""
    from .. import convert

    device = _points_device(x, device)
    x = _asnumpy(x)
    if dist == "cosine":
        xn = x / (np.linalg.norm(x, axis=1, keepdims=True) + 1e-12)
        d = 1.0 - xn @ xn.T
    else:
        sq = np.sum(x * x, axis=1)
        d = np.sqrt(np.maximum(sq[:, None] - 2 * (x @ x.T) + sq[None, :], 0))
    np.fill_diagonal(d, np.inf)
    src, dst = np.nonzero(d <= r)
    g = convert.graph((src, dst), num_nodes=x.shape[0], device=device)
    if get_distances:
        return g, _put(d[src, dst][:, None], device)
    return g


def knn(k: int, x, x_segs, y=None, y_segs=None,
        algorithm: str = "bruteforce", dist: str = "euclidean", *,
        device=None) -> torch.Tensor:
    """Segmented k-nearest-neighbour query (reference ``functional.py``
    ``knn``, C++ ``_CAPI_DGLKNN``): for each point of each segment of
    ``y`` (default ``x``), the ``k`` nearest points of the same segment of
    ``x``, in float64 on the host, nearest first, ties in index order (a
    stable argsort). Returns (2, len(y) * k) int64: row 0 the ``x``
    indices, row 1 the ``y`` (query) indices.

    The reference module also defines an alias of ``knn_graph`` under this
    name (``functional.py:970``); this later definition shadows it there,
    and only this one is ported."""
    device = _points_device(x, device)
    x = _asnumpy(x).astype(np.float64)
    x_segs = _asnumpy(x_segs).astype(np.int64)
    if y is None:
        y, y_segs = x, x_segs
    else:
        y = _asnumpy(y).astype(np.float64)
        y_segs = _asnumpy(y_segs).astype(np.int64)
    if x_segs.shape != y_segs.shape:
        raise DGLError("x_segs and y_segs must have the same length")
    if dist == "cosine":
        x = x / (np.linalg.norm(x, axis=1, keepdims=True) + 1e-5)
        y = y / (np.linalg.norm(y, axis=1, keepdims=True) + 1e-5)
    elif dist != "euclidean":
        raise DGLError(f"unknown dist {dist!r}")
    x_off = np.concatenate([[0], np.cumsum(x_segs)])
    y_off = np.concatenate([[0], np.cumsum(y_segs)])
    src = np.empty(y.shape[0] * k, dtype=np.int64)
    dst = np.empty(y.shape[0] * k, dtype=np.int64)
    for s in range(x_segs.shape[0]):
        xs = x[x_off[s]: x_off[s + 1]]
        ys = y[y_off[s]: y_off[s + 1]]
        if xs.shape[0] < k:
            raise DGLError(f"segment {s} has {xs.shape[0]} x-points < k={k}")
        d = ((ys[:, None, :] - xs[None, :, :]) ** 2).sum(-1)
        nn = np.argsort(d, axis=1, kind="stable")[:, :k] + x_off[s]
        src[y_off[s] * k: y_off[s + 1] * k] = nn.reshape(-1)
        dst[y_off[s] * k: y_off[s + 1] * k] = np.repeat(
            np.arange(y_off[s], y_off[s + 1], dtype=np.int64), k)
    return _put(np.stack([src, dst]), device)


# ---------------------------------------------------------------------------
# spectral and positional encodings (host numpy, dense n x n)
# ---------------------------------------------------------------------------


def _dense_adj(g: Graph, weights=None, assign: bool = False) -> np.ndarray:
    """The (n, n) float64 adjacency: multi-edges summed (of ``weights``,
    default 1), or with ``assign`` set to 1."""
    n = g.num_nodes()
    src, dst = g._relation(None).host_edges()
    a = np.zeros((n, n), np.float64)
    if assign:
        a[src, dst] = 1.0
    else:
        np.add.at(a, (src, dst), 1.0 if weights is None else weights)
    return a


def _edge_weights(g: Graph, eweight_name) -> Optional[np.ndarray]:
    if not eweight_name:
        return None
    rel = g._relation(None)
    return _asnumpy(g._edge_frames[g.canonical_etypes[0]][eweight_name])[
        : rel.num_edges]


def laplacian_lambda_max(g: Graph) -> List[float]:
    """The largest eigenvalue of each batched graph's normalized Laplacian
    ``I − D^-1/2 A D^-1/2`` (scipy ``eigsh``; ``eigvals`` up to 2 nodes)."""
    import scipy.sparse as sp
    from scipy.sparse import linalg as spla

    from ..batch import unbatch

    out = []
    for gg in (unbatch(g) if g.batch_size > 1 else [g]):
        n = gg.num_nodes()
        src, dst = gg._relation(None).host_edges()
        adj = sp.csr_matrix((np.ones(src.size), (src, dst)), shape=(n, n))
        deg = np.asarray(adj.sum(axis=1)).ravel()
        dinv = sp.diags(1.0 / np.sqrt(np.maximum(deg, 1e-12)))
        lap = sp.eye(n) - dinv @ adj @ dinv
        if n <= 2:
            out.append(float(np.linalg.eigvals(lap.toarray()).real.max()))
        else:
            out.append(float(spla.eigsh(lap, 1, which="LM",
                                        return_eigenvectors=False)[0]))
    return out


def random_walk_pe(g: Graph, k: int,
                   eweight_name: Optional[str] = None) -> torch.Tensor:
    """The diagonals of the random-walk matrix's powers 1..k, (N, k)
    float32 (reference ``random_walk_pe``)."""
    a = _dense_adj(g, _edge_weights(g, eweight_name))
    rw = a / np.maximum(a.sum(axis=1, keepdims=True), 1e-12)
    pe, m = [], rw.copy()
    for _ in range(k):
        pe.append(np.diagonal(m).copy())
        m = m @ rw
    return _put(np.stack(pe, axis=1).astype(np.float32), g.device)


def lap_pe(g: Graph, k: int, padding: bool = False,
           return_eigval: bool = False):
    """The eigenvectors of the normalized Laplacian's 2nd to (k+1)-th
    smallest eigenvalues, (N, k) float32, zero-padded with ``padding``
    (reference ``lap_pe``: ``np.linalg.eig``, whose signs and bases of
    repeated eigenvalues the result shares)."""
    n = g.num_nodes()
    a = _dense_adj(g)
    dinv = 1.0 / np.sqrt(np.maximum(a.sum(axis=1), 1e-12))
    lap = np.eye(n) - (dinv[:, None] * a * dinv[None, :])
    if not padding and n <= k:
        raise DGLError(f"need num_nodes > k ({n} <= {k}); use padding=True")
    vals, vecs = np.linalg.eig(lap)
    order = np.argsort(vals.real)
    vals, vecs = vals.real[order], vecs.real[:, order]
    kk = min(k, max(n - 1, 0))
    pe, ev = vecs[:, 1: kk + 1], vals[1: kk + 1]
    if pe.shape[1] < k:
        pe = np.pad(pe, ((0, 0), (0, k - pe.shape[1])))
        ev = np.pad(ev, (0, k - ev.shape[0]))
    pe = _put(pe.astype(np.float32), g.device)
    if return_eigval:
        return pe, _put(ev.astype(np.float32), g.device)
    return pe


def laplacian_pe(g: Graph, k: int, padding: bool = False,
                 return_eigval: bool = False):
    """Deprecated reference alias of ``lap_pe``."""
    return lap_pe(g, k, padding=padding, return_eigval=return_eigval)


def svd_pe(g: Graph, k: int, padding: bool = False, random_flip: bool = True,
           seed: int = 0) -> torch.Tensor:
    """The top-k left and right singular vectors of the 0/1 adjacency
    scaled by the singular values' square roots, (N, 2k) float32; with
    ``random_flip`` each pair's sign drawn from
    ``np.random.default_rng(seed)`` (reference ``svd_pe``)."""
    n = g.num_nodes()
    if not padding and n < k:
        raise DGLError(f"need num_nodes >= k ({n} < {k}); use padding=True")
    u, s, vt = np.linalg.svd(_dense_adj(g, assign=True))
    kk = min(k, n)
    sq = np.sqrt(s[:kk])
    pu, pv = u[:, :kk] * sq, vt[:kk].T * sq
    if random_flip:
        rng = np.random.default_rng(seed)
        signs = np.where(rng.random(kk) < 0.5, -1.0, 1.0)
        pu, pv = pu * signs, pv * signs
    pe = np.concatenate([pu, pv], axis=1)
    if kk < k:
        pe = np.pad(pe, ((0, 0), (0, 2 * (k - kk))))
    return _put(pe.astype(np.float32), g.device)


# ---------------------------------------------------------------------------
# paths
# ---------------------------------------------------------------------------


def _shortest_dist_host(g: Graph, root=None, return_paths: bool = False):
    """``shortest_dist`` on the host: int64 numpy arrays."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import shortest_path

    n = g.num_nodes()
    rel = g._relation(None)
    src, dst = rel.host_edges()
    adj = sp.csr_matrix((np.ones(src.size), (src, dst)), shape=(n, n))
    if not return_paths:
        d = shortest_path(adj, method="D", unweighted=True, indices=root)
        return np.where(np.isinf(d), -1, d).astype(np.int64)
    if root is None:
        raise NotImplementedError("return_paths requires a root")
    d, pred = shortest_path(adj, method="D", unweighted=True,
                            return_predecessors=True, indices=root)
    d = np.where(np.isinf(d), -1, d).astype(np.int64)
    # walk every node's predecessor chain back to the root at once: step s
    # of node t's walk is hop d[t] - 1 - s of its path; a hop's edge is the
    # first edge id of its (u, v) pair
    paths = np.full((n, max(int(d.max()), 1)), -1, np.int64)
    cur = np.arange(n)
    for step in range(int(d.max())):
        t = np.nonzero(d > step)[0]
        p = pred[cur[t]]
        paths[t, d[t] - 1 - step] = rel.first_eids(p, cur[t])
        cur[t] = p
    return d, paths


def shortest_dist(g: Graph, root=None, return_paths: bool = False):
    """Unweighted shortest-path distances (scipy's BFS), int64, -1 where
    unreachable: (N, N), or (N,) from ``root`` (reference
    ``shortest_dist``). With ``return_paths`` (and a root) also the
    (N, max(dist)) edge ids of each path, -1-padded; a hop over parallel
    edges takes the pair's first edge id."""
    out = _shortest_dist_host(g, root, return_paths)
    if return_paths:
        return tuple(_put(a, g.device) for a in out)
    return _put(out, g.device)


def double_radius_node_labeling(g: Graph, src: int, dst: int):
    """DRNL labels for SEAL link prediction (reference
    ``double_radius_node_labeling``): ``1 + min(ds, dt) + (d//2)(d//2 +
    d%2 − 1)`` with ``d = ds + dt``; 1 at ``src`` and ``dst``, 0 where
    unreachable. int64."""
    d_all = _shortest_dist_host(g)
    ds = d_all[src].astype(np.float64)
    dt = d_all[dst].astype(np.float64)
    ds[ds < 0] = np.inf
    dt[dt < 0] = np.inf
    d = ds + dt
    with np.errstate(invalid="ignore"):
        z = 1 + np.minimum(ds, dt) + (d // 2) * ((d // 2) + (d % 2) - 1)
    z[src] = 1.0
    z[dst] = 1.0
    z[~np.isfinite(z)] = 0.0
    return _put(z.astype(np.int64), g.device)


# ---------------------------------------------------------------------------
# diffusions
# ---------------------------------------------------------------------------


def _transition_matrix(g: Graph, eweight_name=None):
    """The column-normalized (in-edge rows) transition matrix, scipy CSR,
    and the node count."""
    import scipy.sparse as sp

    n = g.num_nodes()
    src, dst = g._relation(None).host_edges()
    w = _edge_weights(g, eweight_name)
    a = sp.csr_matrix((np.ones(src.size) if w is None else w, (dst, src)),
                      shape=(n, n))
    deg = np.asarray(a.sum(axis=0)).ravel()
    return a @ sp.diags(1.0 / np.maximum(deg, 1e-12)), n


def ppr(g: Graph, alpha: float = 0.15, eweight_name=None, eps=None,
        avg_degree: int = 5) -> Graph:
    """Personalized-PageRank diffusion ``alpha (I − (1 − alpha) T)^-1``,
    dense on the host, sparsified (reference ``ppr``): the graph of the
    kept entries, their weights in ``edata['w']``."""
    t_mat, n = _transition_matrix(g, eweight_name)
    s = alpha * np.linalg.inv(np.eye(n) - (1 - alpha) * t_mat.toarray())
    return _sparsify_diffusion(g, s, eps, avg_degree)


def heat_kernel(g: Graph, t: float = 5.0, eweight_name=None, eps=None,
                avg_degree: int = 5, k: int = 10) -> Graph:
    """Heat-kernel diffusion ``exp(t (T − I))`` by its Taylor series to
    order ``k``, dense on the host, sparsified (reference
    ``heat_kernel``)."""
    t_mat, n = _transition_matrix(g, eweight_name)
    m = np.asarray(t_mat.todense())
    acc = np.eye(n)
    term = np.eye(n)
    for i in range(1, k + 1):
        term = np.asarray((t / i) * (term @ (m - np.eye(n))))
        acc = acc + term
    return _sparsify_diffusion(g, acc, eps, avg_degree)


def _sparsify_diffusion(g: Graph, s: np.ndarray, eps, avg_degree: int):
    """Keep the entries of ``s`` at least ``eps`` (default: the
    ``avg_degree * n``-th largest, with every entry equal to it), an edge
    ``u -> d`` of weight ``s[d, u]``, in row-major order of ``s``; node
    frames kept, edge frames replaced by ``w``."""
    n = s.shape[0]
    if eps is None:
        k = min(avg_degree * n, s.size - 1)
        eps = np.sort(s.ravel())[-k] if k > 0 else 0.0
    s = np.where(s >= max(eps, 1e-12), s, 0.0)
    dstn, srcn = np.nonzero(s)
    w = s[dstn, srcn]
    out = _rebuild(g, g.to_canonical_etype(None), srcn, dstn)
    out._edge_frames[out.canonical_etypes[0]] = {
        "w": _put(w.astype(np.float32), g.device)}
    return out


def sign_diffusion(g: Graph, k: int, in_feat_name: str = "feat",
                   out_feat_name: str = "out_feat", eweight_name=None,
                   diffuse_op: str = "gcn", alpha: float = 0.2) -> Graph:
    """SIGN's precomputed diffusions (reference ``sign_diffusion``): writes
    ``ndata[f"{out_feat_name}_{i}"]`` for hops i = 1..k, each hop one
    ``update_all(copy_u, sum)`` (``"gcn"``, ``"ppr"``: scaled by the out-
    and in-degrees clamped at 1, to the power -1/2; ``"ppr"`` then mixes
    ``alpha`` of the input back in) or ``update_all(copy_u, mean)``
    (``"raw"``, ``"rw"``). On a graph with a hub plan each hop's sum runs
    kernel B1. ``eweight_name`` is accepted and, as in the reference,
    not read."""
    from .. import function as fn

    h = g.ndata[in_feat_name]
    rel = g._relation(None)
    if diffuse_op in ("gcn", "ppr"):
        ni = torch.rsqrt(torch.clamp(rel.in_degrees().to(h.dtype),
                                     min=1))[:, None]
        no = torch.rsqrt(torch.clamp(rel.out_degrees().to(h.dtype),
                                     min=1))[:, None]
    for i in range(1, k + 1):
        with g.local_scope() as gg:
            if diffuse_op in ("gcn", "ppr"):
                gg.srcdata["h"] = h * no
                gg.update_all(fn.copy_u("h", "m"), fn.sum("m", "h"))
                nxt = gg.dstdata["h"] * ni
            elif diffuse_op in ("raw", "rw"):
                gg.srcdata["h"] = h
                gg.update_all(fn.copy_u("h", "m"), fn.mean("m", "h"))
                nxt = gg.dstdata["h"]
            else:
                raise DGLError(f"Unknown diffuse_op {diffuse_op!r}")
        if diffuse_op == "ppr":
            nxt = (1 - alpha) * nxt + alpha * g.ndata[in_feat_name]
        h = nxt
        g.ndata[f"{out_feat_name}_{i}"] = h
    return g


# ---------------------------------------------------------------------------
# relation algebra
# ---------------------------------------------------------------------------


def metapath_reachable_graph(g: Graph, metapath: Sequence) -> Graph:
    """The pairs joined by a path along ``metapath``'s edge types (scipy
    products of the 0/1 adjacencies), one edge each in the product's COO
    order; the end types' node frames kept (reference
    ``metapath_reachable_graph``)."""
    import scipy.sparse as sp

    from .. import convert

    cets = [g.to_canonical_etype(et) for et in metapath]
    mat = None
    for cet in cets:
        src, dst = g._relations[cet].host_edges()
        m = sp.csr_matrix((np.ones(src.size), (src, dst)),
                          shape=(g.num_nodes(cet[0]), g.num_nodes(cet[2])))
        mat = m if mat is None else mat @ m
    mat = (mat > 0).tocoo()
    st, dt = cets[0][0], cets[-1][2]
    if st == dt:
        out = convert.graph((mat.row, mat.col), num_nodes=g.num_nodes(st),
                            device=g.device)
        out._node_frames.setdefault("_N", {}).update(
            g._node_frames.get(st, {}))
        return out
    out = convert.heterograph({(st, "_E", dt): (mat.row, mat.col)},
                              {st: g.num_nodes(st), dt: g.num_nodes(dt)},
                              device=g.device)
    for nt in (st, dt):
        out._node_frames.setdefault(nt, {}).update(g._node_frames.get(nt, {}))
    return out


def adj_product_graph(A: Graph, B: Graph, weight_name: str) -> Graph:
    """The graph of the product of two graphs' weighted adjacencies
    (scipy; reference ``adj_product_graph``)."""
    return _adj_combine(A, B, weight_name, "product")


def adj_sum_graph(graphs, weight_name: str) -> Graph:
    """The graph of the sum of same-shape graphs' weighted adjacencies
    (reference ``adj_sum_graph``)."""
    out = graphs[0]
    for g in graphs[1:]:
        out = _adj_combine(out, g, weight_name, "sum")
    return out


def _adj_combine(A: Graph, B: Graph, weight_name: str, op: str) -> Graph:
    """``A @ B`` or ``A + B`` of the ``weight_name``-weighted adjacencies as
    scipy CSR, zeros dropped: a graph in the result's COO order, its
    weights (float32) in ``edata[weight_name]``."""
    import scipy.sparse as sp

    from .. import convert

    def mat(g):
        rel = g._relation(None)
        src, dst = rel.host_edges()
        w = _asnumpy(g.edata[weight_name])[: rel.num_edges]
        return sp.coo_matrix((w, (src, dst)),
                             shape=(rel.num_src, rel.num_dst)).tocsr()

    c = (mat(A) @ mat(B)) if op == "product" else (mat(A) + mat(B)).tocsr()
    c.eliminate_zeros()
    coo = c.tocoo()
    g = convert.graph((coo.row, coo.col), num_nodes=max(c.shape),
                      device=A.device)
    g.edata[weight_name] = _put(coo.data.astype(np.float32), A.device)
    return g


def to_levi(g: Graph) -> Graph:
    """The Levi graph (reference ``to_levi``): node types ``node`` and
    ``edge``, a ``belongs`` edge from each edge's source to it and a
    ``points`` edge from it to its destination; node frames on ``node``,
    edge frames on ``edge``."""
    from .. import convert

    rel = g._relation(None)
    src, dst = rel.host_edges()
    eids = np.arange(rel.num_edges, dtype=np.int64)
    out = convert.heterograph(
        {("node", "belongs", "edge"): (src, eids),
         ("edge", "points", "node"): (eids, dst)},
        num_nodes_dict={"node": g.num_nodes(), "edge": rel.num_edges},
        device=g.device)
    out._node_frames.setdefault("node", {}).update(
        g._node_frames.get(g.ntypes[0], {}))
    out._node_frames.setdefault("edge", {}).update(
        g._edge_frames.get(g.canonical_etypes[0], {}))
    return out


def _sort_by_tag(g: Graph, tag, which: str, tag_offset_name: str) -> Graph:
    """The edges reordered by (row, tag of the neighbour), stably
    (``np.lexsort``); the old ids in ``edata[EID]`` and each row's tag
    block offsets, (rows, tags + 1), in ``ndata[tag_offset_name]``."""
    from .. import convert

    rel = g._relation(None)
    E = rel.num_edges
    src, dst = rel.host_edges()
    t = _asnumpy(tag).astype(np.int64)
    num_tags = int(t.max()) + 1 if t.size else 1
    if which == "csr":
        row, nbr, n_rows = src, dst, rel.num_src
    else:
        row, nbr, n_rows = dst, src, rel.num_dst
    key = t[nbr]
    order = np.lexsort((key, row))
    out = convert.graph((src[order], dst[order]), num_nodes=g.num_nodes(),
                        idtype=g.idtype, device=g.device)
    out._node_frames.setdefault(g.ntypes[0], {}).update(
        g._node_frames.get(g.ntypes[0], {}))
    on_dev = _put(order, g.device)
    ef = out._edge_frames.setdefault(out.canonical_etypes[0], {})
    for k, v in g._edge_frames.get(g.canonical_etypes[0], {}).items():
        ef[k] = v[on_dev] if v.shape[0] == E else v
    ef[EID] = on_dev
    counts = np.zeros((n_rows, num_tags), np.int64)
    np.add.at(counts, (row, key), 1)
    offsets = np.zeros((n_rows, num_tags + 1), np.int64)
    offsets[:, 1:] = np.cumsum(counts, axis=1)
    out._node_frames.setdefault(out.ntypes[0], {})[tag_offset_name] = _put(
        offsets, g.device)
    return out


def sort_csr_by_tag(g: Graph, tag, tag_offset_name: str = "_TAG_OFFSET"):
    """Each node's out-neighbours made contiguous by tag (reference
    ``sort_csr_by_tag``, C++ ``CSRSortByTag``): the new graph's edges come
    in the sorted order, so its CSR rows are tag-ordered."""
    return _sort_by_tag(g, tag, "csr", tag_offset_name)


def sort_csc_by_tag(g: Graph, tag, tag_offset_name: str = "_TAG_OFFSET"):
    """Like ``sort_csr_by_tag`` for the in-neighbours (CSC rows)."""
    return _sort_by_tag(g, tag, "csc", tag_offset_name)


# ---------------------------------------------------------------------------
# orders
# ---------------------------------------------------------------------------


def _rcmk_host(g: Graph) -> np.ndarray:
    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    src, dst = g._relation(None).host_edges()
    n = g.num_nodes()
    a = sp.coo_matrix((np.ones(src.size), (src, dst)), shape=(n, n)).tocsr()
    return np.asarray(reverse_cuthill_mckee(a + a.T))


def rcmk_perm(g: Graph) -> torch.Tensor:
    """The reverse Cuthill-McKee order of the symmetrized graph (scipy),
    ``perm[i]`` the old id of new node ``i``, int64 on the graph's
    device."""
    return _put(_rcmk_host(g).astype(np.int64), g.device)


def _metis_host(g: Graph, k: int) -> np.ndarray:
    from ..distributed.partition import metis_partition_assignment

    return np.argsort(metis_partition_assignment(g, k), kind="stable")


def metis_perm(g: Graph, k: int) -> torch.Tensor:
    """The order grouping the multilevel partitioner's ``k`` parts
    (``distributed.partition.metis_partition_assignment``), each part's
    nodes in id order, ``perm[i]`` the old id of new node ``i``, int64 on
    the graph's device."""
    return _put(_metis_host(g, k).astype(np.int64), g.device)
