"""Neighbour sampling on the host (counterpart of
``dgl_tpu/sampling/neighbor.py``; reference ``python/dgl/sampling/
neighbor.py``, C++ ``src/graph/sampling/neighbor/neighbor.cc``).

The picks run in ``csrc/host_ops.cpp`` (``_host.py``), whose draws for a
row are a function of the call's 63-bit seed and the row's node id alone,
so the same ``seed`` gives the reference's picks on any device. Each
function draws from ``np.random.default_rng(seed)`` in the reference's
order. A subgraph comes back on ``g``'s device, a pick array as int64 on
it.

- ``sample_neighbors``: the sampled edges as a subgraph over the whole
  node space (ragged), which ``to_block`` turns into a block;
- ``sample_neighbors_fixed``: (num_seeds, fanout) padded picks.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Union

import numpy as np
import torch

from .. import _host
from ..base import EID, NID, DGLError
from ..graph import Graph, Relation, _asnumpy, ragged_gather

__all__ = ["sample_neighbors", "sample_neighbors_fixed", "in_subgraph_sample",
           "temporal_sample_neighbors", "select_topk",
           "sample_neighbors_biased", "sample_etype_neighbors",
           "sample_neighbors_fused"]

_EMPTY = np.zeros(0, np.int64)


def _ids(x) -> np.ndarray:
    return np.atleast_1d(_asnumpy(x)).astype(np.int64)


def _put(a, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _host_prob(g: Graph, cet, name: str) -> Optional[np.ndarray]:
    """An edge feature as host float64, converted once per version of the
    tensor (at 10^8 edges a conversion a call would dominate sampling):
    an in-place write (``g.edata['p'][mask] = 0``) bumps the tensor's
    version and the next call converts it again. None when the relation
    has no such feature."""
    arr = g._edge_frames.get(cet, {}).get(name)
    if arr is None:
        return None
    key = ((arr._version, arr.data_ptr())
           if isinstance(arr, torch.Tensor) else None)
    cache = g.__dict__.setdefault("_host_prob_cache", {})
    hit = cache.get((cet, name))
    if hit is None or hit[0] is not arr or key is None or hit[1] != key:
        hit = (arr, key, np.ascontiguousarray(_asnumpy(arr), np.float64))
        cache[(cet, name)] = hit
    return hit[2]


def _index(rel: Relation, edge_dir: str):
    """The relation's int64 (indptr, indices, eids) in ``edge_dir``."""
    if edge_dir == "in":
        return _host.int64_arrays(rel, "csc_indptr", "csc_indices",
                                  "csc_eids")
    if edge_dir == "out":
        return _host.int64_arrays(rel, "csr_indptr", "csr_indices",
                                  "csr_eids")
    raise DGLError(f"edge_dir must be 'in' or 'out', got {edge_dir!r}")


def _strip(sub: Graph, copy_ndata: bool, copy_edata: bool) -> Graph:
    if not copy_ndata:
        for nt in sub.ntypes:
            sub._node_frames[nt] = {}
    if not copy_edata:
        for cet in sub.canonical_etypes:
            sub._edge_frames[cet] = {EID: sub._edge_frames[cet][EID]}
    return sub


def _picked_subgraph(g: Graph, edges, copy_ndata, copy_edata) -> Graph:
    from ..subgraph import edge_subgraph

    sub = edge_subgraph(g, edges, relabel_nodes=False, store_ids=True)
    return _strip(sub, copy_ndata, copy_edata)


def _pick(rng: np.random.Generator, indptr, eids, seeds, fanout: int,
          replace: bool, prob: Optional[np.ndarray]) -> np.ndarray:
    """The seeds' picked edge ids, seed after seed (reference ``_pick``):
    fanout -1 keeps every edge; with ``prob`` only edges of positive
    weight are candidates."""
    if fanout >= 0 and seeds.size:
        seed = int(rng.integers(2**63))
        if prob is not None:
            _, eid, mask = _host.sample_neighbors_prob(
                indptr, eids, eids, prob, seeds, fanout, replace, seed)
        else:
            _, eid, mask = _host.sample_neighbors_fixed(
                indptr, eids, eids, seeds, fanout, replace, seed)
        return eid[mask]
    if prob is None:
        return ragged_gather(indptr, eids, seeds)
    # fanout -1 with weights: a row's edges of positive weight
    out = []
    for s in seeds:
        row = eids[indptr[s]:indptr[s + 1]]
        out.append(row[prob[row] > 0])
    return np.concatenate(out) if out else _EMPTY


def _neighbor_picks(g: Graph, nodes, fanout, edge_dir: str = "in",
                    prob: Optional[str] = None, replace: bool = False,
                    exclude_edges=None, seed: Optional[int] = None):
    """``sample_neighbors``'s picked edge ids, a host array per canonical
    edge type."""
    rng = np.random.default_rng(seed)
    if not isinstance(nodes, Mapping):
        if len(g.ntypes) != 1:
            raise DGLError("node dict required for heterographs")
        nodes = {g.ntypes[0]: nodes}
    nodes = {nt: _ids(v) for nt, v in nodes.items()}
    excl = {}
    if exclude_edges is not None:
        if not isinstance(exclude_edges, Mapping):
            excl = {g.canonical_etypes[0]: _asnumpy(exclude_edges)}
        else:
            excl = {g.to_canonical_etype(k): _asnumpy(v)
                    for k, v in exclude_edges.items()}
    edges = {}
    for cet in g.canonical_etypes:
        st, _, dt = cet
        rel = g._relations[cet]
        f = (fanout.get(cet, fanout.get(cet[1], 0))
             if isinstance(fanout, Mapping) else fanout)
        indptr, _, eids = _index(rel, edge_dir)
        seeds = nodes.get(dt if edge_dir == "in" else st, _EMPTY)
        p = _host_prob(g, cet, prob) if prob is not None else None
        picked = _pick(rng, indptr, eids, seeds, int(f), replace, p)
        if cet in excl and picked.size:
            picked = np.setdiff1d(picked, excl[cet])
        edges[cet] = picked
    return edges


def sample_neighbors(g: Graph, nodes, fanout: Union[int, Dict],
                     edge_dir: str = "in", prob: Optional[str] = None,
                     replace: bool = False, copy_ndata: bool = True,
                     copy_edata: bool = True, exclude_edges=None,
                     seed: Optional[int] = None) -> Graph:
    """Up to ``fanout`` in- (or out-) edges of each seed, as a subgraph
    over all of ``g``'s nodes with the parent edge ids in ``edata[EID]``
    (reference ``neighbor.py:222``). ``fanout`` may be a dict keyed by
    edge type (name or triplet); ``exclude_edges`` drops those edge ids
    from the picks (the rest then come sorted by id, as the reference's
    ``setdiff1d`` leaves them)."""
    edges = _neighbor_picks(g, nodes, fanout, edge_dir, prob, replace,
                            exclude_edges, seed)
    return _picked_subgraph(g, edges, copy_ndata, copy_edata)


def _fixed_host(g: Graph, seeds, fanout: int, edge_dir: str = "in",
                replace: bool = False, prob: Optional[str] = None,
                etype=None, seed: Optional[int] = None):
    """``sample_neighbors_fixed``'s numpy arrays."""
    rng = np.random.default_rng(seed)
    cet = g.to_canonical_etype(etype)
    indptr, indices, eids = _index(g._relations[cet], edge_dir)
    seeds = _ids(seeds)
    if prob is None:
        return _host.sample_neighbors_fixed(
            indptr, indices, eids, seeds, fanout, replace,
            int(rng.integers(2**63)))
    p = _host_prob(g, cet, prob)
    if p is None:
        raise DGLError(f"edge feature {prob!r} not found for {cet}")
    return _host.sample_neighbors_prob(indptr, indices, eids, p, seeds,
                                       fanout, replace,
                                       int(rng.integers(2**63)))


def sample_neighbors_fixed(g: Graph, seeds, fanout: int, edge_dir: str = "in",
                           replace: bool = False, prob: Optional[str] = None,
                           etype=None, seed: Optional[int] = None):
    """Up to ``fanout`` picks a seed as (num_seeds, fanout) int64
    neighbour ids, edge ids and a bool mask (False: padding), on ``g``'s
    device. With ``prob``, the weighted pick over edges of positive
    weight; a ``prob`` the relation does not hold raises (the reference
    then draws uniformly in numpy)."""
    return tuple(_put(a, g.device) for a in _fixed_host(
        g, seeds, fanout, edge_dir, replace, prob, etype, seed))


def in_subgraph_sample(g: Graph, nodes) -> Graph:
    """All in-edges of the seeds (reference ``dgl.in_subgraph``)."""
    from ..subgraph import in_subgraph

    return in_subgraph(g, nodes)


def temporal_sample_neighbors(g: Graph, nodes, fanout: int,
                              node_timestamp: str = "timestamp",
                              edge_timestamp: Optional[str] = None,
                              seed_timestamps=None, replace: bool = False,
                              etype=None, seed: Optional[int] = None):
    """Temporal neighbour sampling (reference GraphBolt
    ``temporal_sample_neighbors``): only in-edges strictly older than the
    seed (by ``edata[edge_timestamp]``, else the neighbour's
    ``ndata[node_timestamp]``) are candidates. Returns padded ``(nbr,
    eid, mask)`` as ``sample_neighbors_fixed`` does."""
    rng = np.random.default_rng(seed)
    cet = g.to_canonical_etype(etype)
    indptr, indices, eids = _index(g._relations[cet], "in")
    seeds = _ids(nodes)
    if seed_timestamps is not None:
        seed_ts = np.atleast_1d(_asnumpy(seed_timestamps))
    else:
        seed_ts = _asnumpy(g._node_frames[cet[2]][node_timestamp])[seeds]
    if edge_timestamp is not None:
        e_ts, nbr_ts = _asnumpy(g._edge_frames[cet][edge_timestamp]), None
    else:
        e_ts, nbr_ts = None, _asnumpy(g._node_frames[cet[0]][node_timestamp])
    n = seeds.shape[0]
    nbr = np.zeros((n, fanout), np.int64)
    eid = np.zeros((n, fanout), np.int64)
    mask = np.zeros((n, fanout), bool)
    for i, (s, t) in enumerate(zip(seeds, seed_ts)):
        lo, hi = int(indptr[s]), int(indptr[s + 1])
        row_nbr, row_eid = indices[lo:hi], eids[lo:hi]
        ok = e_ts[row_eid] < t if e_ts is not None else nbr_ts[row_nbr] < t
        cand = np.nonzero(ok)[0]
        if cand.size == 0:
            continue
        if cand.size <= fanout and not replace:
            sel = cand
        elif replace:
            sel = cand[rng.integers(0, cand.size, fanout)]
        else:
            sel = cand[rng.choice(cand.size, fanout, replace=False)]
        k = sel.shape[0]
        nbr[i, :k] = row_nbr[sel]
        eid[i, :k] = row_eid[sel]
        mask[i, :k] = True
    return tuple(_put(a, g.device) for a in (nbr, eid, mask))


def _nodes_or_all(g: Graph, nodes) -> Dict[str, np.ndarray]:
    if nodes is None:
        return {nt: np.arange(g.num_nodes(nt), dtype=np.int64)
                for nt in g.ntypes}
    if not isinstance(nodes, Mapping):
        if len(g.ntypes) != 1:
            raise DGLError("node dict required for heterographs")
        nodes = {g.ntypes[0]: nodes}
    return {nt: _ids(v) for nt, v in nodes.items()}


def select_topk(g: Graph, k, weight: str, nodes=None, edge_dir: str = "in",
                ascending: bool = False, copy_ndata: bool = True,
                copy_edata: bool = True) -> Graph:
    """Each seed's ``k`` in- (or out-) edges of largest ``edata[weight]``
    (smallest with ``ascending``), as ``sample_neighbors`` returns them
    (reference ``neighbor.py:880``); ``k`` may be a dict by canonical
    edge type."""
    nodes = _nodes_or_all(g, nodes)
    edges = {}
    for cet in g.canonical_etypes:
        st, _, dt = cet
        kk = int(k[cet] if isinstance(k, Mapping) else k)
        indptr, _, eids = _index(g._relations[cet], edge_dir)
        seeds = nodes.get(dt if edge_dir == "in" else st, _EMPTY)
        frame = g._edge_frames.get(cet, {})
        if weight not in frame:
            raise DGLError(f"edge weight {weight!r} not found for {cet}")
        w = _asnumpy(frame[weight]).astype(np.float64)
        if seeds.size and kk > 0:
            _, eid_pick, mask = _host.select_topk_rows(
                indptr, eids, eids, w, seeds, kk, not ascending)
            edges[cet] = eid_pick[mask]
            continue
        out = []
        for s in seeds:
            row = eids[indptr[s]:indptr[s + 1]]
            if row.size == 0:
                continue
            order = np.argsort(w[row] if ascending else -w[row],
                               kind="stable")
            out.append(row[order[:min(kk, row.size)]])
        edges[cet] = np.concatenate(out) if out else _EMPTY
    return _picked_subgraph(g, edges, copy_ndata, copy_edata)


def sample_neighbors_biased(g: Graph, nodes, fanout, bias,
                            edge_dir: str = "in",
                            tag_offset_name: str = "_TAG_OFFSET",
                            replace: bool = False, copy_ndata: bool = True,
                            copy_edata: bool = True,
                            seed: Optional[int] = None) -> Graph:
    """Tag-biased neighbour sampling (reference ``neighbor.py:690``):
    neighbours grouped by tag (``transforms.sort_csc_by_tag``), each pick
    of tag ``t`` weighted ``bias[t]``; the weighted pick of
    ``host_ops.cpp`` over the per-edge expansion of the bias."""
    if len(g.ntypes) != 1:
        raise DGLError("biased sampling supports homogeneous graphs")
    nt = g.ntypes[0]
    cet = g.canonical_etypes[0]
    frame = g._node_frames.get(nt, {})
    if tag_offset_name not in frame:
        raise DGLError(
            f"{tag_offset_name!r} missing: run sort_csc_by_tag (edge_dir="
            "'in') or sort_csr_by_tag ('out') first")
    offsets = _asnumpy(frame[tag_offset_name])
    bias = _asnumpy(bias).astype(np.float64)
    indptr, _, eids = _index(g._relations[cet], edge_dir)
    rng = np.random.default_rng(seed)
    seeds = _ids(nodes)
    if seeds.size:
        blocks = np.diff(offsets, axis=1).astype(np.int64)
        n_rows = offsets.shape[0]
        prob_pos = np.repeat(np.tile(bias, n_rows), blocks.ravel())
        if eids.size and prob_pos.shape[0] == indptr[n_rows]:
            prob_eid = np.zeros(eids.max() + 1, np.float64)
            prob_eid[eids[:indptr[n_rows]]] = prob_pos
            _, eid_pick, mask = _host.sample_neighbors_prob(
                indptr, eids, eids, prob_eid, seeds, int(fanout), replace,
                int(rng.integers(2**63)))
            return _picked_subgraph(g, {cet: eid_pick[mask]}, copy_ndata,
                                    copy_edata)
    # tag offsets that do not cover the CSC: the reference's row loop
    out = []
    for s in seeds:
        row = eids[indptr[s]:indptr[s + 1]]
        if row.size == 0:
            continue
        p = np.repeat(bias, np.diff(offsets[s]).astype(np.int64))
        if p.shape[0] != row.size:
            raise DGLError(
                "tag offsets disagree with degree; re-run the tag sort")
        tot = p.sum()
        if tot <= 0:
            continue
        p = p / tot
        take = int(fanout)
        if not replace:
            take = min(take, int(np.count_nonzero(p)))
        out.append(row[rng.choice(row.size, size=take, replace=replace,
                                  p=p)])
    return _picked_subgraph(
        g, {cet: np.concatenate(out) if out else _EMPTY}, copy_ndata,
        copy_edata)


def sample_etype_neighbors(g: Graph, nodes, etype_offset, fanout,
                           edge_dir: str = "in", prob=None,
                           exclude_edges=None, replace: bool = False,
                           copy_ndata: bool = True, copy_edata: bool = True,
                           etype_sorted: bool = False,
                           seed: Optional[int] = None) -> Graph:
    """Per-edge-type fanouts on a homogenised graph whose edge ids are
    grouped by type, ``etype_offset[t]`` the first id of type ``t``
    (reference ``neighbor.py:69``). ``fanout`` is a per-type vector (-1:
    keep all); ``prob`` an optional list of per-type weight arrays by
    within-type edge id."""
    if len(g.ntypes) != 1 or len(g.canonical_etypes) != 1:
        raise DGLError(
            "sample_etype_neighbors operates on the homogenized graph "
            "(one ntype/etype); use sample_neighbors for heterographs")
    rng = np.random.default_rng(seed)
    cet = g.canonical_etypes[0]
    indptr, _, eids = _index(g._relations[cet], edge_dir)
    seeds = _ids(nodes)
    offsets = np.asarray(_asnumpy(etype_offset), dtype=np.int64)
    if offsets[-1] != g.num_edges():
        offsets = np.append(offsets, g.num_edges())
    fan = _ids(fanout)
    num_et = offsets.shape[0] - 1
    if fan.shape[0] != num_et:
        raise DGLError(
            f"fanout has {fan.shape[0]} entries but etype_offset implies "
            f"{num_et} edge types")
    excl = _ids(exclude_edges) if exclude_edges is not None else None
    if prob is None and excl is None and (fan >= 0).all() and seeds.size:
        # edge ids are grouped by type: the type of an id is one repeat
        type_per_edge = np.repeat(np.arange(num_et, dtype=np.int64),
                                  np.diff(offsets))
        _, eid_mat, mask = _host.sample_neighbors_etype(
            indptr, eids, eids, type_per_edge, fan, seeds, replace,
            int(rng.integers(2**63)))
        return _picked_subgraph(g, {cet: eid_mat[mask]}, copy_ndata,
                                copy_edata)
    picked = []
    for s in seeds:
        row = eids[indptr[s]:indptr[s + 1]]
        if excl is not None and row.size:
            row = row[~np.isin(row, excl)]
        if row.size == 0:
            continue
        et = np.searchsorted(offsets, row, side="right") - 1
        for t in range(num_et):
            cand, f = row[et == t], int(fan[t])
            if cand.size == 0 or f == 0:
                continue
            p = None
            if prob is not None and prob[t] is not None:
                p = np.asarray(_asnumpy(prob[t]),
                               dtype=np.float64)[cand - offsets[t]]
                keep = p > 0
                cand, p = cand[keep], p[keep]
                if cand.size == 0:
                    continue
                p = p / p.sum()
            if f < 0 or (not replace and cand.size <= f):
                picked.append(cand)
                continue
            picked.append(cand[rng.choice(cand.size, size=f,
                                          replace=replace, p=p)])
    return _picked_subgraph(
        g, {cet: np.concatenate(picked) if picked else _EMPTY}, copy_ndata,
        copy_edata)


def sample_neighbors_fused(g: Graph, nodes, fanout: Union[int, Dict],
                           edge_dir: str = "in", prob: Optional[str] = None,
                           replace: bool = False, copy_ndata: bool = True,
                           copy_edata: bool = True, exclude_edges=None,
                           mapping: Optional[dict] = None,
                           seed: Optional[int] = None) -> Graph:
    """``sample_neighbors`` with the nodes renumbered (reference
    ``neighbor.py:399``): a type's seeds take ids ``0..len(seeds)-1``,
    the other endpoints follow in order of appearance; the parent ids go
    to ``ndata[NID]`` and ``edata[EID]``, and ``mapping`` (a dict)
    receives each type's parent -> new id array (-1: absent)."""
    sub = sample_neighbors(g, nodes, fanout, edge_dir=edge_dir, prob=prob,
                           replace=replace, exclude_edges=exclude_edges,
                           seed=seed)
    if not isinstance(nodes, Mapping):
        nodes = {g.ntypes[0]: nodes}
    seeds = {nt: _ids(v) for nt, v in nodes.items()}
    order: Dict[str, np.ndarray] = {}
    for nt in g.ntypes:
        parts = [seeds.get(nt, _EMPTY)]
        for cet in g.canonical_etypes:
            src, dst = sub._relations[cet].host_edges()
            if cet[0] == nt:
                parts.append(src.astype(np.int64))
            if cet[2] == nt:
                parts.append(dst.astype(np.int64))
        cat = np.concatenate(parts)
        _, first = np.unique(cat, return_index=True)
        order[nt] = cat[np.sort(first)]
    remap = {}
    for nt, ids in order.items():
        m = np.full(g.num_nodes(nt), -1, dtype=np.int64)
        m[ids] = np.arange(ids.shape[0], dtype=np.int64)
        remap[nt] = m
        if isinstance(mapping, dict):
            mapping[nt] = m
    rels = {}
    for cet in g.canonical_etypes:
        st, _, dt = cet
        src, dst = sub._relations[cet].host_edges()
        rels[cet] = Relation.from_coo(
            remap[st][src], remap[dt][dst], order[st].shape[0],
            order[dt].shape[0], idtype=g.idtype, device=g.device)
    out = Graph(rels, {nt: order[nt].shape[0] for nt in g.ntypes})
    for nt in g.ntypes:
        idx = _put(order[nt], g.device)
        frame = ({k: v[idx] for k, v in g._node_frames.get(nt, {}).items()}
                 if copy_ndata else {})
        frame[NID] = idx
        out._node_frames[nt] = frame
    for cet in g.canonical_etypes:
        sf = sub._edge_frames.get(cet, {})
        frame = dict(sf) if copy_edata else {}
        if EID in sf:
            frame[EID] = sf[EID]
        out._edge_frames[cet] = frame
    return out
