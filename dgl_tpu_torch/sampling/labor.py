"""LABOR sampling (counterpart of ``dgl_tpu/sampling/labor.py``;
reference ``python/dgl/sampling/labor.py:32``, C++
``src/array/cpu/labor_pick.h``, arXiv:2210.13339).

LABOR-0: in-neighbour u of seed t is kept iff ``r_u <= c_t``, ``r_u`` one
uniform per source node shared by all seeds of the layer (overlapping
neighbourhoods pick the same sources) and ``c_t = fanout / degree(t)``.
LABOR-i (``importance_sampling=i``, -1: until convergence) optimises the
``c_t`` against per-source inclusion probabilities (reference
``labor_pick.h:124-151``). Host numpy, vectorised over the whole frontier
as the reference is, so the same ``random_seed`` gives the same edges.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..base import DGLError
from ..graph import Graph, _asnumpy, ragged_gather
from .neighbor import _host_prob, _picked_subgraph

__all__ = ["sample_labors"]

_EPS = 1e-4


def _labor_pick_rows(
    indptr, indices, eids, seeds, num_picks, num_src,
    A_by_eid, importance_sampling, r,
):
    """Vectorized LABOR pick over all seed rows of one relation.

    Returns (picked_eids, importances) — importances per picked edge,
    row-normalized so ``fn.mean`` stays unbiased (reference
    ``labor_pick.h:271-276``).
    """
    starts = indptr[seeds]
    ends = indptr[seeds + 1]
    degs = ends - starts
    keep_rows = degs > 0
    seeds, starts, ends, degs = (
        seeds[keep_rows], starts[keep_rows], ends[keep_rows], degs[keep_rows]
    )
    nrows = seeds.shape[0]
    if nrows == 0:
        return np.zeros(0, np.int64), np.zeros(0)
    # flat hop arrays: one entry per candidate edge, row after row (one
    # ragged arange, the reference's per-row concatenation)
    flat = np.arange(int(degs.sum()), dtype=np.int64) + np.repeat(
        starts - (np.cumsum(degs) - degs), degs)
    seg = np.repeat(np.arange(nrows), degs)
    src_flat = indices[flat]
    eid_flat = eids[flat]

    weighted = A_by_eid is not None
    A_flat = A_by_eid[eid_flat].astype(np.float64) if weighted else None

    # d_i = weighted degree (A_{*s} in the paper); c init = k/d (O(1) form)
    if weighted:
        d = np.bincount(seg, A_flat, nrows)
    else:
        d = degs.astype(np.float64)
    d = np.maximum(d, 1e-300)
    c = num_picks / d
    k = np.minimum(num_picks, degs).astype(np.float64)

    iters = importance_sampling
    if iters >= 0:
        iters += int(weighted)  # weighted c needs one fixed-point pass

    pi = None  # \pi over source nodes (the reference hop_map)
    # the sources the rows reach; only the c-optimisation reads them
    touched = np.unique(src_flat) if iters else None
    var_target = d * d / k
    if weighted:
        var_target += np.bincount(seg, A_flat * A_flat, nrows) - d * d / degs
    prev_ex_nodes = degs.max() * float(nrows)

    it = 0
    while it < iters or iters < 0:
        if not weighted or it:
            ct = c[seg] * (A_flat if (weighted and it == 1) else 1.0)
            hop2 = np.zeros(num_src)
            np.maximum.at(hop2, src_flat, ct)
            if pi is None:
                pi = hop2
            else:
                pi[touched] *= hop2[touched]  # Eq 18
        ps = A_flat if pi is None else pi[src_flat]
        # Eq 22 fixed point: c <- c * var_1(c) / var_target
        for _ in range(64):
            t = np.minimum(1.0, c[seg] * ps)
            if weighted:
                contrib = np.where(A_flat > 0, A_flat * A_flat, 0.0)
                contrib = np.divide(
                    contrib, t, out=np.zeros_like(contrib), where=t > 0
                )
            else:
                contrib = 1.0 / np.maximum(t, 1e-300)
            var_1 = np.bincount(seg, contrib, nrows)
            ratio = var_1 / var_target
            c = c * ratio
            lo = np.minimum(var_1, var_target)
            hi = np.maximum(var_1, var_target)
            if (lo / hi >= 1 - _EPS).all():
                break
        it += 1
        if (not weighted or it > 1) and pi is not None:
            cur_ex_nodes = np.minimum(1.0, pi[touched]).sum()
            if cur_ex_nodes / prev_ex_nodes >= 1 - _EPS:
                break
            prev_ex_nodes = cur_ex_nodes
        if iters >= 0 and it >= iters:
            break

    use_pi = pi is not None and (iters - int(weighted)) != 0
    if use_pi:
        ps_edge = np.minimum(1.0, c[seg] * pi[src_flat])
    elif weighted:
        ps_edge = np.minimum(1.0, c[seg] * A_flat)
    else:
        ps_edge = np.minimum(1.0, c[seg])
    keep = r[src_flat] <= ps_edge
    if weighted:
        keep &= A_flat > 0
    picked = eid_flat[keep]
    w_kept = A_flat[keep] if weighted else np.ones(picked.shape[0])
    imp = w_kept / np.maximum(ps_edge[keep], 1e-300)
    if importance_sampling:
        # per-row mean-preserving normalization (labor_pick.h:271-276)
        seg_kept = seg[keep]
        n_row = np.bincount(seg_kept, minlength=nrows)
        s_row = np.bincount(seg_kept, imp, nrows)
        norm = np.divide(
            n_row, s_row, out=np.ones(nrows), where=s_row > 0
        )
        imp = imp * norm[seg_kept]
    else:
        imp = np.ones(picked.shape[0])
    return picked, imp


def _labor_picks(g: Graph, nodes, fanout, prob: Optional[str] = None,
                 importance_sampling: int = 0,
                 random_seed: Optional[int] = None):
    """``sample_labors``' picked edge ids by canonical edge type and the
    importances (host arrays)."""
    if not isinstance(nodes, dict):
        if len(g.ntypes) != 1:
            raise DGLError("node dict required for heterographs")
        nodes = {g.ntypes[0]: nodes}
    rng = np.random.default_rng(random_seed)
    # one uniform per source node, shared across seeds and edge types
    r_by_ntype = {nt: rng.random(g.num_nodes(nt)) for nt in g.ntypes}
    edges, importances = {}, []
    for cet in g.canonical_etypes:
        st, _, dt = cet
        rel = g._relations[cet]
        f = fanout[cet] if isinstance(fanout, dict) else fanout
        seeds = np.atleast_1d(_asnumpy(nodes.get(dt, np.zeros(0)))).astype(
            np.int64)
        indptr, indices, eids = rel.host_arrays("csc_indptr", "csc_indices",
                                                "csc_eids")
        w_all = _host_prob(g, cet, prob) if prob is not None else None
        if f < 0:
            picked = ragged_gather(indptr, eids, seeds).astype(np.int64)
            imp = np.ones(picked.shape[0])
        else:
            picked, imp = _labor_pick_rows(
                indptr, indices, eids, seeds, int(f), rel.num_src, w_all,
                int(importance_sampling), r_by_ntype[st])
        edges[cet] = picked
        importances.append(imp)
    return edges, importances


def sample_labors(g: Graph, nodes, fanout, edge_dir: str = "in",
                  prob: Optional[str] = None, importance_sampling: int = 0,
                  random_seed: Optional[int] = None, copy_ndata: bool = True,
                  copy_edata: bool = True):
    """Layer-dependent neighbour sampling: returns ``(subgraph,
    importances)``, the subgraph over all of ``g``'s nodes as
    ``sample_neighbors`` returns it, and a float64 importance tensor per
    edge type on ``g``'s device (reference ``labor.py:32``)."""
    if edge_dir != "in":
        raise NotImplementedError("labor sampling supports edge_dir='in'")
    edges, importances = _labor_picks(g, nodes, fanout, prob,
                                      importance_sampling, random_seed)
    return (_picked_subgraph(g, edges, copy_ndata, copy_edata),
            [torch.from_numpy(imp).to(g.device) for imp in importances])
