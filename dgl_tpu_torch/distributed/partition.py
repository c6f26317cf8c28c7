"""Graph partitioning (counterpart of ``dgl_tpu/distributed/partition.py``;
reference ``python/dgl/distributed/partition.py:817`` ``partition_graph``,
``:1098`` ``metis_partition_assignment``, C++
``src/graph/metis_partition.cc``).

Host work: numpy and scipy over three functions of ``csrc/host_ops.cpp``
(``hem_match``, ``aggregate_csr``, ``kway_gains``, bound in ``_host.py``),
the JAX package's multilevel scheme step for step: heavy-edge matching
coarsening, a spectral (Fiedler) bisection of the coarsest graph,
uncoarsening with boundary Kernighan-Lin refinement, recursively to ``k``
parts; above ``_KWAY_EDGE_THRESHOLD`` adjacency entries, one coarsening
chain and a k-way refinement per level. On the same graph the assignment
equals the JAX package's, for a graph on any device. A failed build of
the host library raises; nothing falls back.

``partition_graph`` writes the per-part files (``data.serialize``'s
format, readable by either package), ``load_*`` read them back onto
``device``.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Optional

import numpy as np
import torch

from .. import _host
from ..base import NID, NTYPE, DGLError
from ..graph import Graph, _asnumpy

__all__ = [
    "metis_partition_assignment",
    "random_partition_assignment",
    "partition_graph",
    "load_partition",
    "load_partition_book",
    "load_assignment",
]


def _sym_adj(g: Graph):
    """The symmetrised adjacency of the real edges (weights: multiplicity,
    both directions summed), diagonal dropped, as scipy CSR."""
    import scipy.sparse as sp

    src, dst = g._relation(None).host_edges()
    n = g.num_nodes()
    if n < 2**31:  # the host library's int32 ids
        indptr, cols, w = _host.aggregate_csr(
            np.concatenate([src, dst]), np.concatenate([dst, src]), None, n,
            skip_diag=True)
        return sp.csr_matrix((w, cols, indptr), shape=(n, n))
    a = sp.coo_matrix(
        (np.ones(src.size), (src, dst)), shape=(n, n)
    ).tocsr()
    a = a + a.T
    a.setdiag(0)
    a.eliminate_zeros()
    return a


def _coarsen(adj, weights, wmax=None):
    """One level of heavy-edge matching; returns (coarse_adj, mapping).

    The greedy scan runs in native code (``csrc/host_ops.cpp hem_match``,
    reference METIS HEM ``src/graph/metis_partition.cc``)."""
    import scipy.sparse as sp

    n = adj.shape[0]
    coo = sp.triu(adj, 1).tocoo()
    if coo.data.size and coo.data.max() == coo.data.min():
        # uniform weights (finest level): HEM order is arbitrary — skip
        # the O(E log E) sort (~80 s at 190M nnz)
        row = coo.row.astype(np.int32)
        col = coo.col.astype(np.int32)
    else:
        order = np.argsort(-coo.data, kind="stable")
        row = coo.row[order].astype(np.int32)
        col = coo.col[order].astype(np.int32)
    matched = _host.hem_match(row, col, n)
    # HEM pairing alone stalls on dense coarse graphs (star satellites and
    # saturated neighborhoods stay singleton, reduction drops under 5% and
    # the chain never reaches the coarsest size). METIS absorbs leftover
    # singletons into a matched neighbor's cluster; same here: each lone
    # node joins the cluster of its heaviest (first in sorted order)
    # non-lone neighbor.
    root_count = np.bincount(matched, minlength=n)
    lone = (matched == np.arange(n)) & (root_count[matched] == 1)
    if lone.any():
        partner = np.full(n, -1, dtype=np.int64)
        ends = np.concatenate([row, col]).astype(np.int64)
        other = np.concatenate([col, row]).astype(np.int64)
        # reversed so the heaviest (earliest) incident edge wins
        partner[ends[::-1]] = other[::-1]
        # post-maximal-matching no edge joins two lone nodes, so the
        # partner is matched and its root is final (no chains)
        has = lone & (partner >= 0) & ~lone[np.maximum(partner, 0)]
        if wmax is not None:
            # METIS maxvwgt: don't grow a cluster past wmax, or power-law
            # hubs absorb whole neighborhoods and balance becomes
            # unachievable at the coarsest level
            rw = np.bincount(matched, weights=weights, minlength=n)
            has &= rw[matched[np.maximum(partner, 0)]] < wmax
        matched[has] = matched[partner[has]]
    _, mapping = np.unique(matched, return_inverse=True)
    nc = int(mapping.max()) + 1
    coo_full = adj.tocoo()
    # no dense-coarse prune: both prune variants measured at 100M edges
    # destroyed partition quality through the coarsening chain (the
    # unpruned chain scores 1.00-1.02); memory at 500M+ is handled by
    # disk-spilling the level graphs instead (_kway_multilevel)
    if nc < 2**31:  # the host library's int32 ids
        indptr, cols, w = _host.aggregate_csr(
            mapping[coo_full.row], mapping[coo_full.col],
            coo_full.data, nc, skip_diag=True)
        cadj = sp.csr_matrix((w, cols, indptr), shape=(nc, nc))
    else:
        cadj = sp.coo_matrix(
            (coo_full.data,
             (mapping[coo_full.row], mapping[coo_full.col])),
            shape=(nc, nc),
        ).tocsr()
        cadj.setdiag(0)
        cadj.eliminate_zeros()
    cw = np.bincount(mapping, weights=weights, minlength=nc)
    return cadj, cw, mapping


def _fiedler_bisect(adj, weights, frac=0.5):
    """Split nodes via the Fiedler vector; left side holds ``frac`` of the
    total weight (``frac`` != 0.5 for non-power-of-two part counts)."""
    import scipy.sparse as sp
    from scipy.sparse import linalg as spla

    n = adj.shape[0]
    if n <= 2:
        half = max(1, int(round(n * frac)))
        return np.arange(n) >= half
    deg = np.asarray(adj.sum(axis=1)).ravel()
    lap = sp.diags(deg) - adj
    if n <= 512:
        # coarsest level: exact dense solve, immune to ARPACK stagnation
        vals, vecs = np.linalg.eigh(lap.toarray())
        fiedler = vecs[:, np.argsort(vals)[1]]
    else:
        # power iteration for the 2nd eigenvector of the NORMALIZED
        # adjacency (deflating the trivial sqrt-degree vector): O(nnz)
        # per step and never diverges — ARPACK eigsh("SM") on dense
        # coarse Laplacians silently stagnated at 100M-edge scale and the
        # old random fallback produced near-random top splits (measured
        # cut ratio 4.16x planted; this fix + deeper coarsening restores
        # ~1x)
        d = np.maximum(deg, 1e-9)
        dinv = 1.0 / np.sqrt(d)
        v1 = np.sqrt(d)
        v1 /= np.linalg.norm(v1)
        rng = np.random.default_rng(0)
        v = rng.normal(size=n)
        for _ in range(60):
            v -= v1 * (v1 @ v)
            # shifted operator (I + A_norm)/2: spectrum in [0, 1], so the
            # iteration converges to lambda_2's vector, not a negative-end
            # oscillation on near-bipartite structure
            v = 0.5 * (v + dinv * (adj @ (dinv * v)))
            nv = np.linalg.norm(v)
            if nv < 1e-12:
                v = rng.normal(size=n)
                continue
            v /= nv
        fiedler = v
    order = np.argsort(fiedler)
    csum = np.cumsum(weights[order])
    half = np.searchsorted(csum, csum[-1] * frac)
    side = np.zeros(n, dtype=bool)
    side[order[half + 1 :]] = True
    return side


def _refine(adj, side, weights, passes=3, frac=0.5, tol=0.015):
    """Boundary KL refinement: a forced rebalance stage (coarse levels can
    hand down arbitrary imbalance when supernode weights are lumpy), then
    greedy positive-gain moves keeping balance within ``tol`` (1.5%
    per bisection => <=1.05 overall after log2(k) levels, the METIS
    default ubvec territory)."""
    total = weights.sum()
    target = total * (1.0 - frac)  # side=True is the "right" part
    coo = adj.tocoo()
    w1 = weights[side].sum()  # maintained incrementally across moves
    for _ in range(passes):
        moved = 0
        # gain of moving v = external - internal edge weight
        cross = side[coo.row] != side[coo.col]
        n_ = adj.shape[0]
        ext = np.bincount(coo.row, weights=np.where(cross, coo.data, 0),
                          minlength=n_)
        inte = np.bincount(coo.row, weights=np.where(~cross, coo.data, 0),
                           minlength=n_)
        gain = ext - inte
        if abs(w1 - target) > tol * total:
            # rebalance: move the least-damaging (highest-gain) prefix of
            # heavy-side nodes whose cumulative weight covers the deficit
            heavy = w1 > target
            cand = np.nonzero(side == heavy)[0]
            order_c = cand[np.argsort(-gain[cand])]
            cum = np.cumsum(weights[order_c])
            m = int(np.searchsorted(
                cum, abs(w1 - target) - 0.5 * tol * total)) + 1
            mv = order_c[:m]
            side[mv] = not heavy
            w1 += weights[mv].sum() * (-1.0 if heavy else 1.0)
            moved += mv.size
            # gains are stale after forced moves; recompute next pass
            continue
        cap = max(4, adj.shape[0] // 20)
        for v in np.argsort(-gain)[: 4 * cap]:
            if gain[v] <= 0:
                break
            newbal = w1 - weights[v] if side[v] else w1 + weights[v]
            if abs(newbal - target) > tol * total + weights[v]:
                continue
            side[v] = ~side[v]
            w1 = newbal
            moved += 1
            if moved > cap:
                break
        if moved == 0:
            break
    return side


def _bisect_multilevel(adj, weights, coarsen_to=64, frac=0.5):
    levels = []  # (mapping, finer_adj, finer_weights)
    a, w = adj, weights
    wmax = 6.0 * weights.sum() / coarsen_to  # METIS maxvwgt analog (loose:
    #  tight caps stall coarsening on power-law graphs and triple runtime;
    #  the forced rebalance stage in _refine absorbs the residual lumpiness)
    while a.shape[0] > coarsen_to:
        a2, w2, mapping = _coarsen(a, w, wmax=wmax)
        if a2.shape[0] >= a.shape[0] * 0.95:
            break
        levels.append((mapping, a, w))
        a, w = a2, w2
    side = _fiedler_bisect(a, w, frac)
    side = _refine(a, side, w, frac=frac)
    for mapping, fine_a, fine_w in reversed(levels):
        side = side[mapping]
        side = _refine(fine_a, side, fine_w, frac=frac)
    return side


def _kway_refine(adj, parts, weights, k, passes=2, tol=0.04):
    """Vectorized k-way boundary refinement (Fiduccia-Mattheyses style,
    one shot per pass): move positive-gain boundary nodes to their
    best-connected other part, respecting a per-part weight budget.
    O(E) numpy per pass — this is what makes the coarsen-once k-way path
    viable at 100M edges, where per-bisection KL on the fine graph is
    unaffordable."""
    total = weights.sum()
    cap = total / k * (1 + tol)
    for _ in range(passes):
        # gain computation is the O(E) hot loop: native OpenMP over the
        # CSR rows (csrc kway_gains)
        best, gain = _host.kway_gains(adj.indptr, adj.indices, adj.data,
                                      parts, k)
        best = best.astype(np.int64)
        cand = np.nonzero(gain > 0)[0]
        if cand.size == 0:
            break
        order = cand[np.argsort(-gain[cand])]
        pw = np.bincount(parts, weights=weights, minlength=k)
        # vectorized budget: accept each move while the DESTINATION's
        # cumulative inflow fits its headroom and the SOURCE's cumulative
        # outflow keeps it above the floor (no per-node Python loop — at
        # 100M edges the candidate set is millions of nodes)
        floor = total / k * (1 - tol)
        w_c = weights[order]
        dst_c = best[order]
        src_c = parts[order]
        accept = np.ones(order.size, bool)
        for p in range(k):
            din = dst_c == p
            cum_in = np.cumsum(w_c[din])
            accept[din] &= cum_in <= max(cap - pw[p], 0.0)
            dout = src_c == p
            cum_out = np.cumsum(w_c[dout])
            accept[dout] &= cum_out <= max(pw[p] - floor, 0.0)
        mv = order[accept]
        if mv.size == 0:
            break
        parts[mv] = best[mv]
    return parts


# graphs past this edge count take the coarsen-once k-way path instead of
# recursive bisection (which re-coarsens the giant graph once per split)
# Route to coarsen-once k-way above this symmetric-adjacency nnz: the
# per-bisection path re-coarsens subgraphs O(k) times (2x slower at 10M
# edges) and its two-way refinement mishandles power-law hubs (measured
# cut/planted 1.55 vs kway's 0.98 on a 1M-node zipf-degree planted SBM —
# tests/test_distributed.py::test_powerlaw_planted_cut).
_KWAY_EDGE_THRESHOLD = 10_000_000
_KWAY_COARSE_TO = 60_000


def _kway_multilevel(adj, weights, k):
    """Coarsen ONCE to ~_KWAY_COARSE_TO supernodes, run the recursive
    bisection there, then project down with a k-way refinement pass per
    level (METIS's kway scheme, ``src/graph/metis_partition.cc``). The
    per-bisection path re-coarsens the whole graph O(k) times — measured
    unaffordable at 100M edges.

    The chain is UNPRUNED (every prune variant measured at 100M+ was
    refinement-unrecoverable — see _coarsen); memory at 500M+ edges is
    handled by spilling level graphs to disk and reloading one at a time
    during refinement (the 500M chain held ~6 x ~10 GB levels and OOM'd
    a 125 GB host when kept in RAM).

    ``DGL_TPU_KWAY_WORKDIR=<dir>`` makes the run CHECKPOINTED and
    RESUMABLE (the reference's multi-hour ParMETIS pipelines restart
    from scratch on failure; at 1.6B-edge scale a single-host run is
    hours, so every level graph + mapping + the coarse assignment
    persist and a rerun skips completed stages). With a workdir, every
    level spills regardless of size.

    ``DGL_TPU_KWAY_REFINE_STRIDE=<s>`` refines only every s-th level
    (others project straight through their mapping and skip the graph
    spill). Community-graph chains keep nnz nearly flat, so at 1.6B
    edges storing every level graph (~11 x ~20 GB) exceeds a single
    host's disk; stride 2 halves both the spill footprint and the
    refinement wall. Quality must be gated at a smaller scale before
    trusting a stride (the refinement ladder is what recovers the
    coarse assignment's error — see docs/performance.md). MEASURED
    round 5: stride 2 passes the 1M deep-chain gate (cut ratio 1.0000)
    but FAILS at 100M edges — cut ratio 1.5252 vs the full chain's
    1.0000 on the same graph (docs/partition_100m_r05.json vs
    partition_100m_r03.json). Dense community chains keep ~90% of nnz
    at every level, so each projected-through level leaves boundary
    error the next refined level cannot fully recover. Leave stride at
    1 for quality-bearing artifacts; disk pressure at 1.6B needs a
    different lever (e.g. spill compression or partial-level spills)."""
    workdir = os.environ.get("DGL_TPU_KWAY_WORKDIR")
    stride = max(1, int(os.environ.get("DGL_TPU_KWAY_REFINE_STRIDE",
                                        "1")))
    # default spill threshold keeps 100M-edge chains (levels ~180M nnz,
    # ~2.5 GB each) in RAM; 500M-edge levels (~950M nnz) spill
    spill_nnz = int(os.environ.get("DGL_TPU_KWAY_SPILL_NNZ",
                                    str(400_000_000)))
    if workdir is not None:
        os.makedirs(workdir, exist_ok=True)
        spill_nnz = -1  # spill every level: the checkpoint IS the spill
    spill_dir = workdir

    def _ck(name):
        return None if workdir is None else os.path.join(workdir, name)

    def _maybe_spill(a, w, idx):
        nonlocal spill_dir
        if a.nnz <= spill_nnz:
            return (a, w)
        import scipy.sparse as _sp

        if spill_dir is None:
            spill_dir = tempfile.mkdtemp(prefix="dgl_tpu_kway_")
        path = os.path.join(spill_dir, f"lvl{idx}.npz")
        if not (workdir and os.path.exists(path)):
            _sp.save_npz(path, a)
            np.save(path + ".w.npy", w)
        return (path, None)

    def _load_level(stored):
        a_or_path, w = stored
        if isinstance(a_or_path, str):
            import scipy.sparse as _sp

            return (_sp.load_npz(a_or_path),
                    np.load(a_or_path + ".w.npy"))
        return a_or_path, w

    levels = []
    a, w = adj, weights
    wmax = 8.0 * weights.sum() / _KWAY_COARSE_TO
    def _stored_for(i):
        p = os.path.join(workdir, f"lvl{i}.npz")
        return (p, None) if os.path.exists(p) else (None, None)

    coarsest_ck = _ck("coarsest.npz")
    if coarsest_ck and os.path.exists(coarsest_ck):
        # full-chain resume: per-level mappings + the coarsest graph
        # (strided levels have a mapping but no spilled graph)
        import scipy.sparse as _sp

        i = 0
        while os.path.exists(os.path.join(workdir, f"map{i}.npy")):
            levels.append((np.load(os.path.join(workdir,
                                                 f"map{i}.npy")),
                           _stored_for(i)))
            i += 1
        a = _sp.load_npz(coarsest_ck)
        w = np.load(os.path.join(workdir, "coarsest.w.npy"))
    else:
        if workdir:
            # mid-chain resume: redo from the deepest SPILLED level whose
            # prefix of mappings is complete (strided levels between are
            # recomputed deterministically)
            import scipy.sparse as _sp

            j = 0
            i = 1
            while os.path.exists(os.path.join(workdir,
                                                f"map{i - 1}.npy")):
                if os.path.exists(os.path.join(workdir,
                                                 f"lvl{i}.npz")):
                    j = i
                i += 1
            if j > 0:
                for i in range(j):
                    levels.append((np.load(os.path.join(
                        workdir, f"map{i}.npy")), _stored_for(i)))
                a = _sp.load_npz(os.path.join(workdir, f"lvl{j}.npz"))
                w = np.load(os.path.join(workdir, f"lvl{j}.npz.w.npy"))
        while a.shape[0] > _KWAY_COARSE_TO:
            a2, w2, mapping = _coarsen(a, w, wmax=wmax)
            if a2.shape[0] >= a.shape[0] * 0.95:
                break
            lvl = len(levels)
            if lvl % stride == 0:
                levels.append((mapping, _maybe_spill(a, w, lvl)))
            else:
                # strided level: projection-only during refinement —
                # the graph is neither kept nor spilled
                levels.append((mapping, (None, None)))
            if workdir:
                # incremental checkpoint: the mapping makes the level
                # resumable the moment its graph spill lands
                np.save(os.path.join(workdir, f"map{lvl}.npy"),
                        mapping)
            del a, w
            a, w = a2, w2
        if workdir:
            import scipy.sparse as _sp

            _sp.save_npz(coarsest_ck, a)
            np.save(os.path.join(workdir, "coarsest.w.npy"), w)
    parts_ck = _ck("coarse_parts.npy")
    if parts_ck and os.path.exists(parts_ck):
        parts_c = np.load(parts_ck)
    else:
        parts_c = _assign_via_bisection(a, w, k)
        if parts_ck:
            np.save(parts_ck, parts_c)
    del a, w
    for lvl in range(len(levels) - 1, -1, -1):
        mapping, stored = levels[lvl]
        ref_ck = _ck(f"parts_lvl{lvl}.npy")
        if ref_ck and os.path.exists(ref_ck):
            parts_c = np.load(ref_ck)
            continue
        parts_c = parts_c[mapping]
        if stored[0] is None and stored[1] is None:
            # strided level: projection only (no graph kept)
            if ref_ck:
                np.save(ref_ck, parts_c)
            continue
        fine_a, fine_w = _load_level(stored)
        # 3 passes measured at 100M edges: cut ratio vs planted 1.92 ->
        # 1.00 for +28% wall time (docs/partition_100m_r03.json)
        parts_c = _kway_refine(fine_a, parts_c, fine_w, k, passes=3)
        if fine_a is not adj:
            del fine_a
        if ref_ck:
            np.save(ref_ck, parts_c)
    if spill_dir is not None and workdir is None:
        shutil.rmtree(spill_dir, ignore_errors=True)
    return parts_c


def _assign_via_bisection(adj, weights, k):
    parts = np.zeros(adj.shape[0], dtype=np.int64)

    def recurse(node_ids, sub_adj, sub_w, nparts, offset):
        if nparts == 1:
            parts[node_ids] = offset
            return
        left_parts = nparts // 2
        side = _bisect_multilevel(sub_adj, sub_w, frac=left_parts / nparts)
        left = node_ids[~side]
        right = node_ids[side]
        la = sub_adj[~side][:, ~side]
        ra = sub_adj[side][:, side]
        recurse(left, la, sub_w[~side], left_parts, offset)
        recurse(right, ra, sub_w[side], nparts - left_parts,
                offset + left_parts)

    recurse(np.arange(adj.shape[0]), adj, weights, k, 0)
    return parts


def metis_partition_assignment(
    g: Graph, k: int, balance_ntypes=None, balance_edges=False,
    objtype: str = "cut",
) -> np.ndarray:
    """Multilevel part assignment (reference API ``partition.py:1098``):
    recursive bisection up to ~30M edges, coarsen-once k-way above (the
    100M+ scale path). Returns (N,) int64 part ids."""
    if k <= 1:
        return np.zeros(g.num_nodes(), dtype=np.int64)
    adj = _sym_adj(g)
    n = adj.shape[0]
    weights = np.ones(n)
    if balance_edges:
        # weight by degree so each part owns a comparable edge count
        # (reference multi-constraint METIS objective, approximated as a
        # single combined node weight)
        deg = np.asarray(adj.sum(axis=1)).ravel()
        weights = weights + deg * (n / max(deg.sum(), 1.0))
    if balance_ntypes is not None:
        # scale each type so every type contributes equal total weight;
        # a weight-balanced split then also balances types approximately
        bt = np.asarray(balance_ntypes).ravel().astype(np.int64)
        counts = np.bincount(bt).astype(np.float64)
        weights = weights + (n / np.maximum(counts, 1.0) / counts.size)[bt]
    if adj.nnz > _KWAY_EDGE_THRESHOLD:
        parts = _kway_multilevel(adj, weights, k)
    else:
        parts = _assign_via_bisection(adj, weights, k)
    return _enforce_balance(adj, parts, weights, k)


def _enforce_balance(adj, parts, weights, k, tol=0.04):
    """Final balance pass: per-bisection tolerances compound over log2(k)
    levels, so guarantee ``max/mean <= 1 + tol`` (METIS ubvec 1.05
    territory) by moving the cheapest boundary nodes out of overweight
    parts into the lightest adjacent part. Moves prefer nodes with the
    most edges already pointing into the destination (minimal cut
    damage)."""
    pw = np.bincount(parts, weights=weights, minlength=k)
    mean = weights.sum() / k
    cap = mean * (1 + tol)
    if pw.max() <= cap:
        return parts
    indptr, indices = adj.indptr, adj.indices

    def edges_into(members, target):
        starts = indptr[members].astype(np.int64)
        lens = (indptr[members + 1] - indptr[members]).astype(np.int64)
        tot = int(lens.sum())
        idx = np.repeat(starts, lens) + (
            np.arange(tot) - np.repeat(np.cumsum(lens) - lens, lens))
        owner = np.repeat(np.arange(members.size), lens)
        hit = parts[indices[idx]] == target
        return np.bincount(owner[hit], minlength=members.size)

    for p in np.argsort(-pw):
        guard = 0
        while pw[p] > cap and guard < 4 * k:
            guard += 1
            dest = int(np.argmin(pw))
            if dest == p or pw[dest] >= mean:
                break
            members = np.nonzero(parts == p)[0]
            gain = edges_into(members, dest) - edges_into(members, p)
            order = np.argsort(-gain)
            w_m = weights[members[order]]
            cum = np.cumsum(w_m)
            need = min(pw[p] - cap, mean - pw[dest])
            m = int(np.searchsorted(cum, need)) + 1
            mv = members[order[:m]]
            parts[mv] = dest
            moved = weights[mv].sum()
            pw[p] -= moved
            pw[dest] += moved
            if moved <= 0:
                break
    return parts


def random_partition_assignment(g: Graph, k: int, seed: int = 0) -> np.ndarray:
    """(reference ``partition.py`` random method)."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, k, g.num_nodes()).astype(np.int64)


def edge_cut(g: Graph, parts: np.ndarray) -> int:
    """The number of real edges whose endpoints lie in different parts."""
    src, dst = g._relation(None).host_edges()
    return int((parts[src] != parts[dst]).sum())


def _gather_in_neighbors(indptr, indices, frontier):
    """All in-neighbors of ``frontier`` (CSC), fully vectorized."""
    starts = indptr[frontier]
    lens = indptr[frontier + 1] - starts
    total = int(lens.sum())
    if total == 0:
        return np.empty(0, dtype=indices.dtype)
    # flat positions: for each frontier node, the range [start, start+len)
    reps = np.repeat(starts - np.concatenate([[0], np.cumsum(lens)[:-1]]), lens)
    pos = np.arange(total) + reps
    return indices[pos]


def _with_halo(indptr, indices, owned, hops, n):
    """The sorted ids of ``owned`` and their ``hops``-hop in-neighbour
    halo (vectorized CSC range gather + boolean membership)."""
    keep = np.zeros(n, dtype=bool)
    keep[owned] = True
    frontier = owned
    for _ in range(hops):
        nbrs = np.unique(_gather_in_neighbors(indptr, indices, frontier))
        nxt = nbrs[~keep[nbrs]]
        keep[nxt] = True
        frontier = nxt
        if nxt.size == 0:
            break
    return np.nonzero(keep)[0].astype(np.int64)


def _relabel(parts):
    """(new -> old, old -> new) ids that give each part a contiguous
    range, parts in order, old order kept within a part."""
    order = np.argsort(parts, kind="stable")
    new_of_old = np.empty(parts.shape[0], dtype=np.int64)
    new_of_old[order] = np.arange(parts.shape[0])
    return order, new_of_old


def _put(a, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def partition_graph(
    g: Graph,
    graph_name: str,
    num_parts: int,
    out_path: str,
    *,
    part_method: str = "metis",
    balance_ntypes=None,
    balance_edges: bool = False,
    num_hops: int = 1,
    return_mapping: bool = False,
    parts: Optional[np.ndarray] = None,
):
    """Partition + write per-part shards and a partition book
    (reference ``partition.py:817``). Nodes are relabeled so each part owns a
    contiguous id range (RangePartitionBook, ``graph_partition_book.py:541``).
    ``part<p>.npz`` holds the node subgraph of part ``p``'s nodes and their
    ``num_hops`` in-neighbour halo, with ``ndata["_new_id"]`` (int64) and
    ``ndata["inner_node"]`` (bool).
    """
    from ..data.serialize import save_graphs
    from ..subgraph import node_subgraph

    if parts is None:
        if part_method == "metis":
            parts = metis_partition_assignment(
                g, num_parts, balance_ntypes, balance_edges
            )
        elif part_method == "random":
            parts = random_partition_assignment(g, num_parts)
        else:
            raise DGLError(f"Unknown part_method {part_method!r}")
    parts = _asnumpy(parts)
    n = g.num_nodes()
    order, new_of_old = _relabel(parts)
    counts = np.bincount(parts, minlength=num_parts)
    ranges = np.concatenate([[0], np.cumsum(counts)])

    os.makedirs(out_path, exist_ok=True)
    book = {
        "graph_name": graph_name,
        "num_parts": num_parts,
        "node_ranges": ranges.tolist(),
        "num_nodes": int(n),
        "num_edges": int(g.num_edges()),
        "part_method": part_method,
        "edge_cut": edge_cut(g, parts),
    }
    with open(os.path.join(out_path, f"{graph_name}.json"), "w") as f:
        json.dump(book, f)
    # assignment array: lets training jobs rebuild their shard tables
    # without re-partitioning
    np.save(os.path.join(out_path, "assignment.npy"), parts)

    indptr, indices = g._relation(None).host_arrays("csc_indptr",
                                                    "csc_indices")
    for p in range(num_parts):
        owned_old = order[ranges[p] : ranges[p + 1]]
        all_nodes = _with_halo(indptr, indices, owned_old, num_hops, n)
        sub = node_subgraph(g, all_nodes)
        sub.ndata["_new_id"] = _put(new_of_old[all_nodes], g.device)
        sub.ndata["inner_node"] = _put(np.isin(all_nodes, owned_old),
                                       g.device)
        save_graphs(os.path.join(out_path, f"part{p}.npz"), [sub])
    if return_mapping:
        return order, new_of_old
    return None


def load_partition(part_path: str, part_id: int, device="cuda"):
    """(reference ``partition.py:286``). Returns (part_graph, book), the
    graph on ``device``."""
    from ..data.serialize import load_graphs

    d = os.path.dirname(part_path) if part_path.endswith(".json") else part_path
    book = load_partition_book(part_path)
    graphs, _ = load_graphs(os.path.join(d, f"part{part_id}.npz"),
                            device=device)
    return graphs[0], book


def load_assignment(part_path: str) -> np.ndarray:
    """Per-node part ids saved by ``partition_graph`` (host int64)."""
    d = os.path.dirname(part_path) if part_path.endswith(".json") else part_path
    return np.load(os.path.join(d, "assignment.npy"))


def load_partition_book(part_path: str):
    from .graph_partition_book import RangePartitionBook

    if not part_path.endswith(".json"):
        cands = [f for f in os.listdir(part_path) if f.endswith(".json")]
        if not cands:
            raise DGLError(f"No partition book under {part_path}")
        part_path = os.path.join(part_path, cands[0])
    with open(part_path) as f:
        book = json.load(f)
    return RangePartitionBook(
        np.asarray(book["node_ranges"]), book["num_parts"], meta=book
    )


def hetero_partition_assignment(g: Graph, k: int) -> "np.ndarray":
    """Partition a heterograph via its homogeneous encoding (reference
    ``graph_partition_book.py:480-530`` homogeneous-ID scheme): returns
    per-ntype part assignments {ntype: (N_nt,) int64}."""
    from ..convert import to_homogeneous

    homo = to_homogeneous(g)
    parts = metis_partition_assignment(homo, k)
    ntype_ids = _asnumpy(homo._node_frames["_N"][NTYPE])
    local_ids = _asnumpy(homo._node_frames["_N"][NID])
    out = {}
    for i, nt in enumerate(g.ntypes):
        sel = ntype_ids == i
        arr = np.zeros(g.num_nodes(nt), np.int64)
        arr[local_ids[sel]] = parts[sel]
        out[nt] = arr
    return out


def partition_hetero_graph(g: Graph, graph_name: str, num_parts: int,
                           out_path: str, **kwargs):
    """Partition + write shards for a heterograph (per-part node-induced
    hetero subgraphs with inner-node markers per ntype)."""
    from ..data.serialize import save_graphs
    from ..subgraph import node_subgraph

    assign = hetero_partition_assignment(g, num_parts)
    os.makedirs(out_path, exist_ok=True)
    cut = 0
    for cet in g.canonical_etypes:
        st, _, dt = cet
        src, dst = g._relations[cet].host_edges()
        cut += int((assign[st][src] != assign[dt][dst]).sum())
    book = {
        "graph_name": graph_name,
        "num_parts": num_parts,
        "hetero": True,
        "ntypes": list(g.ntypes),
        "num_nodes_per_type": {nt: g.num_nodes(nt) for nt in g.ntypes},
        "edge_cut": cut,
    }
    with open(os.path.join(out_path, f"{graph_name}.json"), "w") as f:
        json.dump(book, f)
    for p in range(num_parts):
        owned = {nt: np.nonzero(assign[nt] == p)[0] for nt in g.ntypes}
        # 1-hop halo per relation (in-neighbors of owned dst nodes)
        keep = {
            nt: np.zeros(g.num_nodes(nt), dtype=bool) for nt in g.ntypes
        }
        for nt, ids in owned.items():
            keep[nt][ids] = True
        for cet in g.canonical_etypes:
            st, _, dt = cet
            indptr, indices = g._relations[cet].host_arrays("csc_indptr",
                                                            "csc_indices")
            nbrs = _gather_in_neighbors(indptr, indices, owned[dt])
            keep[st][nbrs] = True
        nodes = {
            nt: np.nonzero(m)[0].astype(np.int64) for nt, m in keep.items()
        }
        sub = node_subgraph(g, nodes)
        for nt in g.ntypes:
            inner = np.isin(nodes[nt], owned[nt])
            sub._node_frames.setdefault(nt, {})["inner_node"] = _put(
                inner, g.device)
        save_graphs(os.path.join(out_path, f"part{p}.npz"), [sub])
    return assign


__all__ += ["hetero_partition_assignment", "partition_hetero_graph",
            "edge_cut"]
