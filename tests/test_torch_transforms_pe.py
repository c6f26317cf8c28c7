"""The rest of the port's graph utilities (``dgl_tpu_torch.transforms``)
against ``dgl_tpu.transforms``: the positional encodings, the diffusions,
the kNN and radius graphs and the segmented kNN query, shortest paths and
DRNL labels, the relation algebra, the tag sorts and the orders.

The graphs are small and made with numpy from seeds (the homogeneous graph
of ``test_torch_graph_utils`` with multi-edges, self-loops and frames, its
padded copy, the graph of three node types). Tolerances:

- host numpy and scipy results (the encodings, distances, paths, labels,
  diffusions, tag sorts, orders, the radius graph and the kNN query): the
  same calls on the same inputs, so exactly equal arrays, graphs and
  frames; index dtypes by the port's rule (the reference's int64 numpy comes
  out int32 without x64, the port keeps int64);
- ``laplacian_lambda_max``: ARPACK starts from a random vector, so the
  reference differs from itself run to run; on symmetric graphs the
  eigenvalue converges to rtol 1e-9;
- device float paths (``pairwise_squared_distance``, ``sign_diffusion``
  without a plan): rtol = atol = 1e-5 (of max|ref|);
- ``knn_graph``: the edge lists are held exactly. Both sides compute the
  float32 distances as ``|x|² − 2 x·x + |x|²``; a different matmul order
  can swap two neighbours whose distances lie within its rounding. Such a
  swap is allowed only where the two neighbours' exact (float64) distances
  to the query agree within 1e-5 of the largest squared norm, and is
  counted; on integer points every distance is exact, ties among them
  included, and the lists must be identical (a tie goes to the lower
  index on both sides);
- ``sign_diffusion`` over a hub plan (the reference compiled with
  ``xla_allow_excess_precision`` off so that it keeps its bf16 roundings,
  as the port does): each hop within rtol = atol = 2e-2 of max|ref|, the
  plan's bound; kernel B1's wrapper called once a hop.
"""
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dgl_tpu
from dgl_tpu.base import DGLError as JDGLError
from dgl_tpu.transforms import functional as JF
import dgl_tpu_torch as dt
from dgl_tpu_torch.base import DGLError
from dgl_tpu_torch.ops import hub_spmm
from dgl_tpu_torch.transforms import functional as TF
from test_torch_graph_utils import hetero_pair, homo_pair, np_of, same_graph

EXACT = "exact"


def _weighted(pair):
    """A 1-D edge weight ``we`` (>0) and an integer tag per node on both
    graphs."""
    jg, tg = pair
    rng = np.random.default_rng(21)
    ep = jg._relation(None).num_edges_padded
    w = (rng.random(ep) + 0.5).astype(np.float32)
    jg.edata["we"], tg.edata["we"] = jnp.asarray(w), torch.from_numpy(w)
    return jg, tg


GRAPHS = {"homo": lambda: _weighted(homo_pair()),
          "padded": lambda: _weighted(homo_pair(padded=True))}


def _same(got, ref, tol, what="result"):
    if isinstance(ref, dgl_tpu.Graph):
        same_graph(got, ref, what)
    elif isinstance(ref, (tuple, list)):
        assert len(got) == len(ref), what
        for i, (a, b) in enumerate(zip(got, ref)):
            _same(a, b, tol, f"{what}[{i}]")
    elif isinstance(ref, (bool, int, float, str)):
        assert got == ref, (what, got, ref)
    else:
        g, r = np_of(got), np.asarray(ref)
        assert g.shape == r.shape, (what, g.shape, r.shape)
        if tol == EXACT or r.dtype.kind != "f":
            assert np.array_equal(g, r), (what, g, r)
        else:
            np.testing.assert_allclose(
                g, r, rtol=tol, atol=tol * max(np.abs(r).max(), 1e-30),
                err_msg=what)


def _run(pair, fn, tol=EXACT):
    """``fn(module, graph)`` on both sides: equal results, or both raise
    the same kind of error."""
    jg, tg = pair
    try:
        ref = fn(JF, jg)
    except (JDGLError, NotImplementedError) as exc:
        with pytest.raises(DGLError if isinstance(exc, JDGLError)
                           else NotImplementedError):
            fn(TF, tg)
        return None
    got = fn(TF, tg)
    _same(got, ref, tol)
    return got, ref


HOST = {
    "random_walk_pe": lambda m, g: m.random_walk_pe(g, 5),
    "random_walk_pe_weighted": lambda m, g: m.random_walk_pe(g, 3, "we"),
    "lap_pe": lambda m, g: m.lap_pe(g, 4),
    "lap_pe_eigval": lambda m, g: m.lap_pe(g, 3, return_eigval=True),
    "lap_pe_padding": lambda m, g: m.lap_pe(g, 15, padding=True,
                                            return_eigval=True),
    "lap_pe_too_few_nodes": lambda m, g: m.lap_pe(g, 12),
    "laplacian_pe": lambda m, g: m.laplacian_pe(g, 2),
    "svd_pe": lambda m, g: m.svd_pe(g, 4),
    "svd_pe_no_flip": lambda m, g: m.svd_pe(g, 3, random_flip=False),
    "svd_pe_seed_padding": lambda m, g: m.svd_pe(g, 14, padding=True,
                                                 seed=3),
    "svd_pe_too_few_nodes": lambda m, g: m.svd_pe(g, 13),
    "shortest_dist": lambda m, g: m.shortest_dist(g),
    "shortest_dist_root": lambda m, g: m.shortest_dist(g, root=4),
    "shortest_dist_paths": lambda m, g: m.shortest_dist(
        g, root=0, return_paths=True),
    "shortest_dist_paths_other_root": lambda m, g: m.shortest_dist(
        g, root=7, return_paths=True),
    "shortest_dist_paths_no_root": lambda m, g: m.shortest_dist(
        g, return_paths=True),
    "double_radius_node_labeling": lambda m, g:
        m.double_radius_node_labeling(g, 0, 5),
    "double_radius_node_labeling_self": lambda m, g:
        m.double_radius_node_labeling(g, 3, 3),
    "ppr": lambda m, g: m.ppr(g),
    "ppr_eps_weighted": lambda m, g: m.ppr(g, alpha=0.3, eweight_name="we",
                                           eps=0.02),
    "ppr_avg_degree": lambda m, g: m.ppr(g, avg_degree=2),
    "heat_kernel": lambda m, g: m.heat_kernel(g),
    "heat_kernel_eps_weighted": lambda m, g: m.heat_kernel(
        g, t=2.0, eweight_name="we", eps=0.05, k=6),
    "to_levi": lambda m, g: m.to_levi(g),
    "sort_csr_by_tag": lambda m, g: m.sort_csr_by_tag(
        g, np.array([0, 2, 1, 1, 0, 2, 2, 1, 0, 0, 1, 2])),
    "sort_csc_by_tag": lambda m, g: m.sort_csc_by_tag(
        g, np.array([3, 0, 0, 1, 2, 3, 1, 0, 2, 1, 3, 0]), "offs"),
    "rcmk_perm": lambda m, g: m.rcmk_perm(g),
    "reorder_graph_rcmk": lambda m, g: m.reorder_graph(g, "rcmk"),
    "reorder_graph_rcmk_no_ids": lambda m, g: m.reorder_graph(
        g, "rcmk", store_ids=False),
    "adj_sum_graph": lambda m, g: m.adj_sum_graph(
        [g, m.reverse(g), m.remove_edges(g, np.arange(5))], "we"),
    "adj_product_graph": lambda m, g: m.adj_product_graph(
        g, m.reverse(g), "we"),
    "radius_graph": lambda m, g: m.radius_graph(g.ndata["x"], 1.5),
    "radius_graph_cosine_distances": lambda m, g: m.radius_graph(
        g.ndata["x"], 0.6, dist="cosine", get_distances=True),
    "knn_query": lambda m, g: m.knn(3, g.ndata["x"], np.array([5, 7])),
    "knn_query_y_cosine": lambda m, g: m.knn(
        2, g.ndata["x"], np.array([4, 8]), g.ndata["x"][np.arange(11, -1, -1)],
        np.array([6, 6]), dist="cosine"),
    "knn_query_short_segment": lambda m, g: m.knn(
        5, g.ndata["x"], np.array([3, 9])),
    "knn_query_segments_differ": lambda m, g: m.knn(
        2, g.ndata["x"], np.array([6, 6]), g.ndata["x"], np.array([12])),
}


@pytest.mark.parametrize("graph", sorted(GRAPHS))
@pytest.mark.parametrize("name", sorted(HOST))
def test_host_utility_matches(name, graph):
    """(The point functions read the graph's CPU features: the port puts
    their results on the CPU.)"""
    _run(GRAPHS[graph](), HOST[name])


def test_metapath_reachable_graph():
    """Paths within and across types, on graphs without and with node
    frames. Where the path ends at its start type and that type has node
    frames, the reference raises ``KeyError`` (it writes them into its new
    graph's ``"_N"`` frame, which does not exist yet); the port carries
    them (ROADMAP queue C)."""
    cases = [(homo_pair(frames=False), [["_E", "_E"], ["_E"] * 3]),
             (hetero_pair(frames=False), [["buys", "bought_by"],
                                          ["bought_by", "buys", "bought_by"],
                                          ["buys", "has"]]),
             (hetero_pair(), [["buys", "has"], ["bought_by", "buys", "has"]])]
    for (jg, tg), paths in cases:
        for path in paths:
            same_graph(TF.metapath_reachable_graph(tg, path),
                       JF.metapath_reachable_graph(jg, path), str(path))
    jg, tg = hetero_pair()
    with pytest.raises(KeyError):
        JF.metapath_reachable_graph(jg, ["buys", "bought_by"])
    out = TF.metapath_reachable_graph(tg, ["buys", "bought_by"])
    assert out.ntypes == ["_N"] and out.ndata["x"] is tg.nodes["user"].data["x"]
    ref = JF.metapath_reachable_graph(hetero_pair(frames=False)[0],
                                      ["buys", "bought_by"])
    np.testing.assert_array_equal(np_of(out.edges()[0]),
                                  np.asarray(ref.edges()[0]))


def test_adj_graphs_weights_and_zeros():
    """Products and sums keep scipy's order and drop zero entries (a
    weight and its negation cancel)."""
    rng = np.random.default_rng(5)
    src, dst = rng.integers(0, 8, 20), rng.integers(0, 8, 20)
    w = rng.normal(size=20).astype(np.float32)
    pairs = []
    for ww in (w, -w):
        jg = dgl_tpu.graph((src, dst), num_nodes=8)
        tg = dt.graph((src, dst), num_nodes=8, device="cpu")
        jg.edata["v"], tg.edata["v"] = jnp.asarray(ww), torch.from_numpy(ww)
        pairs.append((jg, tg))
    (ja, ta), (jb, tb) = pairs
    out = TF.adj_sum_graph([ta, tb], "v")
    same_graph(out, JF.adj_sum_graph([ja, jb], "v"))
    assert out.num_edges() == 0
    same_graph(TF.adj_product_graph(ta, tb, "v"),
               JF.adj_product_graph(ja, jb, "v"))


def _symmetric(n, e, seed):
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    return np.r_[src, dst], np.r_[dst, src]


def test_laplacian_lambda_max_batched():
    parts = [(_symmetric(n, e, s), n) for s, (n, e) in
             enumerate([(9, 20), (2, 1), (14, 30), (6, 12)])]
    jgs = [dgl_tpu.graph(p, num_nodes=n) for p, n in parts]
    tgs = [dt.graph(p, num_nodes=n, device="cpu") for p, n in parts]
    for got, ref in ((TF.laplacian_lambda_max(dt.batch(tgs)),
                      JF.laplacian_lambda_max(dgl_tpu.batch(jgs))),
                     (TF.laplacian_lambda_max(tgs[2]),
                      JF.laplacian_lambda_max(jgs[2]))):
        assert len(got) == len(ref)
        np.testing.assert_allclose(got, ref, rtol=1e-9)


def test_shortest_paths_take_first_edge_of_a_pair():
    """On a multigraph each hop's edge id is the first id of its (u, v)
    pair, whichever the BFS used."""
    src = np.array([0, 1, 0, 2, 1, 1, 3])
    dst = np.array([1, 2, 1, 3, 2, 3, 4])
    jg = dgl_tpu.graph((src, dst), num_nodes=6)
    tg = dt.graph((src, dst), num_nodes=6, device="cpu")
    d, paths = TF.shortest_dist(tg, root=0, return_paths=True)
    jd, jpaths = JF.shortest_dist(jg, root=0, return_paths=True)
    _same((d, paths), (jd, jpaths), EXACT)
    assert paths[4].tolist() == [0, 5, 6]
    assert d[5] == -1 and (paths[5] == -1).all()


# ---------------------------------------------------------------------------
# point clouds on the device
# ---------------------------------------------------------------------------


def _points(n, d, seed, integer=False):
    rng = np.random.default_rng(seed)
    if integer:
        return rng.integers(0, 4, size=(n, d)).astype(np.float32)
    return rng.normal(size=(n, d)).astype(np.float32)


def _knn_edges_equal(got, ref, x, k, dist="euclidean"):
    """``got`` and ``ref`` (src arrays of kNN graphs, query-major, k a
    query) equal, but for slots whose two neighbours' float64 distances to
    the query agree within rounding (the module docstring). Returns the
    number of such slots."""
    got, ref = np_of(got).reshape(-1, k), np.asarray(ref).reshape(-1, k)
    x64 = x.astype(np.float64)
    if dist == "cosine":
        x64 = x64 / np.linalg.norm(x64, axis=1, keepdims=True)
        tol = 1e-6
    else:
        tol = 1e-5 * float((x64 * x64).sum(1).max())
    q = np.arange(got.shape[0])[:, None]

    def d(nbr):
        diff = x64[q] - x64[nbr]
        return (diff * diff).sum(-1)

    differ = got != ref
    assert np.all(np.abs(d(got) - d(ref))[differ] <= tol), (
        np.nonzero(differ), got[differ], ref[differ])
    assert all(len(set(row)) == k for row in got)
    return int(differ.sum())


@pytest.mark.parametrize("dist", ["euclidean", "cosine"])
@pytest.mark.parametrize("n,dim,k", [(40, 3, 5), (25, 8, 30), (1, 2, 3)])
def test_knn_graph_matches(n, dim, k, dist):
    x = _points(n, dim, n + dim)
    got = TF.knn_graph(torch.from_numpy(x), k, dist=dist)
    ref = JF.knn_graph(x, k, dist=dist)
    kk = min(k, n)
    assert got.num_edges() == ref.num_edges() == n * kk
    np.testing.assert_array_equal(np_of(got.edges()[1]),
                                  np.asarray(ref.edges()[1]))
    _knn_edges_equal(got.edges()[0], ref.edges()[0], x, kk, dist)
    assert got.device.type == "cpu"


def test_knn_graph_ties_go_to_the_lower_index():
    """Integer points: every float32 distance is exact and many tie; the
    lists must equal the reference's, which puts the lower index first."""
    x = _points(60, 2, 3, integer=True)
    for k in (4, 9):
        got = TF.knn_graph(x, k, device="cpu")
        ref = JF.knn_graph(x, k)
        same_graph(got, ref)
        src = np_of(got.edges()[0]).reshape(60, k)
        d = ((x[:, None] - x[src]) ** 2).sum(-1)
        ties = (d[:, 1:] == d[:, :-1])
        assert ties.any() and np.all(src[:, 1:][ties] > src[:, :-1][ties])


def test_segmented_knn_graph_and_distances():
    x = _points(30, 3, 4)
    segs = [7, 2, 21]
    got = TF.segmented_knn_graph(torch.from_numpy(x), 4, segs)
    ref = JF.segmented_knn_graph(x, 4, segs)
    np.testing.assert_array_equal(np_of(got.edges()[1]),
                                  np.asarray(ref.edges()[1]))
    assert got.num_edges() == ref.num_edges() == 4 * 7 + 2 * 2 + 4 * 21
    # k shrinks to a short segment's size: compare segment by segment
    offs = np.r_[0, np.cumsum([4 * 7, 2 * 2, 4 * 21])]
    for (lo, hi), kk in zip(zip(offs[:-1], offs[1:]), (4, 2, 4)):
        _knn_edges_equal(np_of(got.edges()[0])[lo:hi],
                         np.asarray(ref.edges()[0])[lo:hi], x, kk)
    _same(TF.pairwise_squared_distance(torch.from_numpy(x)),
          JF.pairwise_squared_distance(x), 1e-5)


def test_knn_name_binds_the_segmented_query():
    """Both modules define ``knn`` twice; the later definition, the
    segmented query, is the one the module name binds."""
    for mod in (JF, TF, dgl_tpu.transforms, dt.transforms):
        assert list(inspect.signature(mod.knn).parameters)[:3] == [
            "k", "x", "x_segs"], mod
    x = _points(10, 3, 1)
    out = TF.knn(2, x, [10], device="cpu")
    assert out.shape == (2, 20) and out.dtype == torch.int64
    np.testing.assert_array_equal(np_of(out), JF.knn(2, x, [10]))


def test_metis_order_names_queue_a11():
    """The METIS order, once ROADMAP queue A11's first part: the
    partitioner's order and ``reorder_graph(g, "metis")`` against the
    reference's (``tests/test_torch_partition.py`` holds them on larger
    graphs); an unknown order still raises. The reference's partitioner
    matches the port's only over its native library, loaded first."""
    from test_torch_sampling import reference_native

    reference_native()
    jg, tg = homo_pair()
    assert np.array_equal(np_of(TF.metis_perm(tg, 2)), JF.metis_perm(jg, 2))
    same_graph(TF.reorder_graph(tg, "metis"), JF.reorder_graph(jg, "metis"),
               "reorder_graph(metis)", batch=False)
    with pytest.raises(DGLError):
        TF.reorder_graph(tg, "nope")


# ---------------------------------------------------------------------------
# sign_diffusion
# ---------------------------------------------------------------------------

OPS = ["gcn", "ppr", "raw", "rw"]
N, E, F, K = 300, 2400, 6, 3


@pytest.mark.parametrize("graph", sorted(GRAPHS))
@pytest.mark.parametrize("op", OPS)
def test_sign_diffusion_plain(graph, op):
    jg, tg = GRAPHS[graph]()
    x = np.random.default_rng(2).normal(size=(12, 4)).astype(np.float32)
    jg.ndata["feat"], tg.ndata["feat"] = jnp.asarray(x), torch.from_numpy(x)
    ref = JF.sign_diffusion(jg, K, diffuse_op=op, alpha=0.3,
                            eweight_name="we")
    got = TF.sign_diffusion(tg, K, diffuse_op=op, alpha=0.3,
                            eweight_name="we")
    assert got is tg
    for i in range(1, K + 1):
        _same(got.ndata[f"out_feat_{i}"], ref.ndata[f"out_feat_{i}"], 1e-5,
              f"hop {i}")


def test_sign_diffusion_unknown_op():
    jg, tg = GRAPHS["homo"]()
    for g, m, err in ((jg, JF, JDGLError), (tg, TF, DGLError)):
        g.ndata["feat"] = g.ndata["x"]
        with pytest.raises(err):
            m.sign_diffusion(g, 2, diffuse_op="heat")


@pytest.fixture(scope="module")
def planned():
    rng = np.random.default_rng(0)
    src = np.minimum(rng.zipf(1.5, E) - 1, N - 1)
    dst = rng.integers(0, N, E)
    kw = dict(num_hubs=8, precision="int8")
    jp, jperm = dgl_tpu.transforms.reorder_for_spmm(
        dgl_tpu.graph((src, dst), num_nodes=N), **kw)
    tp, tperm = dt.transforms.reorder_for_spmm(
        dt.graph((src, dst), num_nodes=N, device="cpu"), **kw)
    np.testing.assert_array_equal(jperm, tperm)
    assert tp._relation().hub_plan is not None
    return jp, tp


@pytest.fixture
def b1_calls(monkeypatch):
    calls = [0]
    orig = hub_spmm.shell_prefix_sum

    def count(*a, **k):
        calls[0] += 1
        return orig(*a, **k)

    monkeypatch.setattr(hub_spmm, "shell_prefix_sum", count)
    return calls


@pytest.mark.parametrize("op", OPS)
def test_sign_diffusion_over_the_hub_plan(planned, b1_calls, op):
    """Each hop's sum (or mean) goes through the hub plan, kernel B1's
    wrapper once a hop, and holds the reference's plan path."""
    jp, tp = planned
    x = np.random.default_rng(3).normal(size=(N, F)).astype(np.float32)

    def ref_fn(xx):
        g = jp.local_var()
        g.ndata["feat"] = xx
        JF.sign_diffusion(g, K, diffuse_op=op)
        return tuple(g.ndata[f"out_feat_{i}"] for i in range(1, K + 1))

    ref = jax.jit(ref_fn).lower(jnp.asarray(x)).compile(
        compiler_options={"xla_allow_excess_precision": False})(
        jnp.asarray(x))
    tp = tp.local_var()
    tp.ndata["feat"] = torch.from_numpy(x)
    b1_calls[0] = 0
    TF.sign_diffusion(tp, K, diffuse_op=op)
    assert b1_calls[0] == K
    for i in range(1, K + 1):
        _same(tp.ndata[f"out_feat_{i}"], ref[i - 1], 2e-2, f"hop {i}")
