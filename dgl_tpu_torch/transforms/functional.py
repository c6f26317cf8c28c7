"""Graph transforms (counterpart of ``dgl_tpu/transforms/functional.py``).

Structure changes run on the host with numpy (scipy where the reference
uses it) and return new graphs on the input graph's device, with the
reference's edge order. Ported: the structural transforms
(``add_self_loop``, ``remove_self_loop``, ``add_reverse_edges``,
``add_edges``, ``remove_edges``, ``add_nodes``, ``remove_nodes``,
``to_bidirected``, ``to_simple``, ``reverse``, ``khop_adj``,
``khop_graph``, ``compact_graphs``, ``to_block``, ``line_graph``,
``norm_by_dst``, ``is_bidirected``, ``update_graph_structure``), the frame
casts (``to_float``, ``to_double``, ``to_half``, ``to_bfloat16``), the
relabelling that the SpMM plans need, ``reorder_graph`` with a given
permutation and ``reorder_for_spmm`` (hub plan, and with ``weighted=True``
the shell plan). The positional encodings, the point-cloud graphs, the
diffusions and the other orders come later (ROADMAP queue A9).
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional

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
    from .. import convert

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

    # destination positions by a stable search against the seed order
    kept = {}
    for cet in g.canonical_etypes:
        s, d = g._relations[cet].host_edges()
        dst_arr = dst_nodes.get(cet[2], empty)
        order = np.argsort(dst_arr, kind="stable")
        sorted_d = dst_arr[order]
        pos = np.searchsorted(sorted_d, d)
        safe = np.minimum(pos, max(sorted_d.shape[0] - 1, 0))
        keep = ((sorted_d[safe] == d) if sorted_d.size
                else np.zeros(d.shape, bool))
        new_d = order[pos[keep]] if sorted_d.size else empty
        kept[cet] = (s[keep], new_d, np.nonzero(keep)[0])

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

    ``node_permute_algo='custom'`` takes ``permute_config['nodes_perm']``:
    ``perm[i]`` is the old id of new node ``i``. Edges keep their ids and
    order; node features are carried over permuted. The 'rcmk' and 'metis'
    orders come with the graph utilities (ROADMAP queue A9)."""
    if node_permute_algo != "custom":
        if node_permute_algo in ("rcmk", "metis"):
            raise NotImplementedError(
                f"reorder_graph({node_permute_algo!r}): ROADMAP queue A9")
        raise DGLError(f"Unknown node_permute_algo {node_permute_algo!r}")
    n = g.num_nodes()
    rel = g._relation(None)
    src, dst = rel.host_arrays("src", "dst")
    src, dst = src[: rel.num_edges], dst[: rel.num_edges]
    perm = np.asarray((permute_config or {})["nodes_perm"], np.int64)
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
