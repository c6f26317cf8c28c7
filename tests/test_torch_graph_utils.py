"""The port's ``Graph`` queries, views, structure facts, frames, formats
and sparse matrices, and the other constructors of ``convert.py``, against
``dgl_tpu``.

The graphs are small and made with numpy from seeds: a homogeneous graph
with multi-edges and self-loops, the same graph with padded edges, a
graph of three node and three edge types, and a block. Every result is
compared array for array (values and index dtypes) and frame for frame;
where the reference raises, the port raises.

Tolerances: exact (index work and copies), f32 values rtol = atol = 1e-6.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sps
import torch

import dgl_tpu
from dgl_tpu.base import DGLError as JDGLError
import dgl_tpu_torch as dt
from dgl_tpu_torch.base import DGLError

TOL = dict(rtol=1e-6, atol=1e-6)


def np_of(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def assert_same(got, ref, what="value"):
    """Arrays, tuples, dicts and scalars equal; index arrays exactly."""
    if isinstance(ref, dict):
        assert set(got) == set(ref), (what, set(got), set(ref))
        for k in ref:
            assert_same(got[k], ref[k], f"{what}[{k!r}]")
        return
    if isinstance(ref, (tuple, list)):
        assert len(got) == len(ref), what
        for i, (a, b) in enumerate(zip(got, ref)):
            assert_same(a, b, f"{what}[{i}]")
        return
    if isinstance(ref, (bool, int, float, str, np.bool_, type(None))):
        assert got == ref, (what, got, ref)
        return
    r, g = np.asarray(ref), np_of(got)
    assert g.shape == r.shape, (what, g.shape, r.shape)
    if r.dtype.kind == "f":
        np.testing.assert_allclose(g, r, err_msg=what, **TOL)
    else:
        assert np.array_equal(g, r), (what, g, r)


def same_graph(tg, jg, what="graph", batch=True):
    """Schema, counts, every relation array (dtype included) and every
    frame equal; with ``batch`` the per-graph sizes too."""
    assert tg.is_block == jg.is_block, what
    assert tuple(tg.canonical_etypes) == tuple(jg.canonical_etypes), what
    assert tg.ntypes == jg.ntypes, what
    assert tg._num_src_nodes == jg._num_src_nodes, what
    assert tg._num_dst_nodes == jg._num_dst_nodes, what
    for cet in jg.canonical_etypes:
        tr, jr = tg._relations[cet], jg._relations[cet]
        assert tr.num_edges == jr.num_edges, (what, cet)
        assert (tr.max_in_degree, tr.max_out_degree) == (
            jr.max_in_degree, jr.max_out_degree), (what, cet)
        for f in jr.ARRAY_FIELDS:
            a, b = getattr(tr, f), getattr(jr, f)
            if b is None:
                assert a is None, (what, cet, f)
                continue
            assert np_of(a).dtype == np.asarray(b).dtype, (what, cet, f)
            assert np.array_equal(np_of(a), np.asarray(b)), (what, cet, f)
    # a graph's destination frames are its node frames; only a block has
    # its own (the reference's to_bidirected leaves a stale alias behind)
    names = ("_node_frames", "_edge_frames") + (
        ("_dst_frames",) if jg.is_block else ())
    if not tg.is_block:
        assert tg._dst_frames is tg._node_frames, what
    for name in names:
        got = {k: v for k, v in getattr(tg, name).items() if v}
        ref = {k: v for k, v in getattr(jg, name).items() if v}
        assert_same(got, ref, f"{what}.{name}")
    if batch:
        assert tg.batch_size == jg.batch_size, what
        if jg._batch_num_nodes is not None:
            for nt in jg.ntypes:
                assert_same(tg.batch_num_nodes(nt), jg.batch_num_nodes(nt))
            for cet in jg.canonical_etypes:
                assert_same(tg.batch_num_edges(cet), jg.batch_num_edges(cet))


def homo_arrays(n=12, e=40, seed=0):
    """Edges with two multi-edges and two self-loops, as numpy arrays."""
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    src = np.concatenate([src, src[:2], [3, 5]])
    dst = np.concatenate([dst, dst[:2], [3, 5]])
    return src, dst, n


def with_frames(jg, tg, seed=1, ntypes=None):
    """The same random node and edge features on both graphs."""
    rng = np.random.default_rng(seed)
    for nt in (ntypes or jg.ntypes):
        x = rng.normal(size=(jg.num_nodes(nt), 3)).astype(np.float32)
        jg._node_frames.setdefault(nt, {})["x"] = jnp.asarray(x)
        tg._node_frames.setdefault(nt, {})["x"] = torch.from_numpy(x)
    for cet in jg.canonical_etypes:
        ep = jg._relations[cet].num_edges_padded
        w = rng.normal(size=(ep, 2)).astype(np.float32)
        jg._edge_frames.setdefault(cet, {})["w"] = jnp.asarray(w)
        tg._edge_frames.setdefault(cet, {})["w"] = torch.from_numpy(w)
    return jg, tg


def homo_pair(padded=False, frames=True):
    src, dst, n = homo_arrays()
    kw = {}
    if padded:
        E = src.shape[0]
        src = np.concatenate([src, np.full(5, n)])
        dst = np.concatenate([dst, np.full(5, n)])
        kw = {"num_edges": E}
    jg = dgl_tpu.graph((src, dst), num_nodes=n, **kw)
    tg = dt.graph((src, dst), num_nodes=n, device="cpu", **kw)
    return with_frames(jg, tg) if frames else (jg, tg)


HETERO_COUNTS = {"user": 9, "item": 7, "tag": 4}


def hetero_data(seed=2):
    rng = np.random.default_rng(seed)
    return {
        ("user", "buys", "item"): (rng.integers(0, 9, 20),
                                   rng.integers(0, 7, 20)),
        ("item", "bought_by", "user"): (rng.integers(0, 7, 15),
                                        rng.integers(0, 9, 15)),
        ("item", "has", "tag"): (rng.integers(0, 7, 10),
                                 rng.integers(0, 4, 10)),
    }


def hetero_pair(frames=True):
    data = hetero_data()
    jg = dgl_tpu.heterograph(data, dict(HETERO_COUNTS))
    tg = dt.heterograph(data, dict(HETERO_COUNTS), device="cpu")
    return with_frames(jg, tg) if frames else (jg, tg)


def block_pair():
    rng = np.random.default_rng(3)
    src, dst = rng.integers(0, 10, 25), rng.integers(0, 4, 25)
    jb = dgl_tpu.create_block((src, dst), 10, 4)
    tb = dt.create_block((src, dst), 10, 4, device="cpu")
    x = rng.normal(size=(10, 2)).astype(np.float32)
    y = rng.normal(size=(4, 2)).astype(np.float32)
    jb.srcdata["x"], tb.srcdata["x"] = jnp.asarray(x), torch.from_numpy(x)
    jb.dstdata["y"], tb.dstdata["y"] = jnp.asarray(y), torch.from_numpy(y)
    return jb, tb


def both_raise(jcall, tcall):
    with pytest.raises(JDGLError):
        jcall()
    with pytest.raises(DGLError):
        tcall()


# ---------------------------------------------------------------------------
# batch info
# ---------------------------------------------------------------------------


def test_batch_info_defaults_and_setters():
    jg, tg = homo_pair()
    assert tg.batch_size == jg.batch_size == 1
    assert_same(tg.batch_num_nodes(), jg.batch_num_nodes())
    assert_same(tg.batch_num_edges(), jg.batch_num_edges())
    for g in (jg, tg):
        g.set_batch_num_nodes(np.array([5, 7]))
        g.set_batch_num_edges(np.array([20, 24]))
    assert tg.batch_size == jg.batch_size == 2
    assert_same(tg.batch_num_nodes(), jg.batch_num_nodes())
    assert_same(tg.batch_num_edges(), jg.batch_num_edges())
    for g in (tg.to("cpu"), tg.structural_clone(), tg.local_var()):
        assert g.batch_size == 2
        assert_same(g.batch_num_nodes(), jg.batch_num_nodes())
        assert_same(g.batch_num_edges(), jg.batch_num_edges())
    with tg.local_scope():
        tg.ndata["z"] = torch.zeros(12)
        assert_same(tg.batch_num_edges(), jg.batch_num_edges())
    jh, th = hetero_pair()
    for g in (jh, th):
        g.set_batch_num_nodes({"user": np.array([4, 5]),
                               "item": np.array([3, 4]),
                               "tag": np.array([2, 2])})
        g.set_batch_num_edges({"buys": np.array([8, 12]),
                               "bought_by": np.array([5, 10]),
                               "has": np.array([4, 6])})
    for nt in HETERO_COUNTS:
        assert_same(th.batch_num_nodes(nt), jh.batch_num_nodes(nt))
    for et in ("buys", "bought_by", "has"):
        assert_same(th.batch_num_edges(et), jh.batch_num_edges(et))
    both_raise(lambda: jh.batch_num_nodes(), lambda: th.batch_num_nodes())


# ---------------------------------------------------------------------------
# queries
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("padded", [False, True])
def test_queries_match(padded):
    jg, tg = homo_pair(padded)
    src, dst, n = homo_arrays()
    assert_same(tg.find_edges([0, 5, 41]), jg.find_edges(np.array([0, 5,
                                                                     41])))
    # single pairs give a 0-dim result; a multi-edge, a self-loop, a miss
    for u, v in ((src[0], dst[0]), (3, 3), (0, 11), (src[7], dst[7])):
        assert_same(tg.has_edges_between(u, v), jg.has_edges_between(u, v))
    qu = np.concatenate([src[:10], [3, 0, 11, 5]])
    qv = np.concatenate([dst[:10], [3, 11, 0, 5]])
    assert_same(tg.has_edges_between(qu, qv), jg.has_edges_between(qu, qv))
    hit = np.asarray(jg.has_edges_between(qu, qv))
    assert_same(tg.edge_ids(qu[hit], qv[hit]), jg.edge_ids(qu[hit],
                                                           qv[hit]))
    # the multi-edges: the first in CSR order, the smallest id
    assert_same(tg.edge_ids(src[:2], dst[:2]), jg.edge_ids(src[:2],
                                                           dst[:2]))
    assert_same(tg.edge_ids(src[1], dst[1]), jg.edge_ids(src[1], dst[1]))
    miss = np.nonzero(~hit)[0][0]
    both_raise(lambda: jg.edge_ids(qu[miss], qv[miss]),
               lambda: tg.edge_ids(qu[miss], qv[miss]))
    for u in (0, 3, 5, 11):
        assert_same(tg.successors(u), jg.successors(u))
        assert_same(tg.predecessors(u), jg.predecessors(u))
    for form in ("uv", "eid", "all"):
        for nodes in ([3, 0, 3], 5, []):
            assert_same(tg.in_edges(nodes, form=form),
                        jg.in_edges(np.asarray(nodes), form=form))
            assert_same(tg.out_edges(nodes, form=form),
                        jg.out_edges(np.asarray(nodes), form=form))
    both_raise(lambda: jg.in_edges([1], form="xy"),
               lambda: tg.in_edges([1], form="xy"))
    assert_same(tg.has_nodes([0, 11, 12, -1]),
                jg.has_nodes(np.array([0, 11, 12, -1])))
    assert_same(tg.has_nodes(4), jg.has_nodes(4))
    assert_same(tg.nodes_ids(), jg.nodes_ids())
    for order in ("eid", "srcdst"):
        assert_same(tg.all_edges(form="all", order=order)[1:],
                    jg.all_edges(form="all", order=order)[1:])
    assert {k: tuple(s) for k, (s, _) in tg.node_attr_schemes().items()} \
        == {k: tuple(s) for k, (s, _) in jg.node_attr_schemes().items()}


def test_hetero_queries_and_ids():
    jg, tg = hetero_pair()
    for et in ("buys", "bought_by", "has"):
        assert_same(tg.successors(2, etype=et), jg.successors(2, etype=et))
        assert_same(tg.predecessors(1, etype=et),
                    jg.predecessors(1, etype=et))
        assert_same(tg.in_edges([0, 2], form="all", etype=et),
                    jg.in_edges(np.array([0, 2]), form="all", etype=et))
        assert_same(tg.find_edges([0, 3], etype=et),
                    jg.find_edges(np.array([0, 3]), etype=et))
        assert tg.get_etype_id(et) == jg.get_etype_id(et)
    src, dst = hetero_data()[("user", "buys", "item")]
    assert_same(tg.edge_ids(src[:4], dst[:4], etype="buys"),
                jg.edge_ids(src[:4], dst[:4], etype="buys"))
    for nt in list(HETERO_COUNTS) + [None]:
        if nt is None:
            both_raise(lambda: jg.get_ntype_id(None),
                       lambda: tg.get_ntype_id(None))
        else:
            assert tg.get_ntype_id(nt) == jg.get_ntype_id(nt)
    both_raise(lambda: jg.get_ntype_id("x"), lambda: tg.get_ntype_id("x"))
    assert tg.is_unibipartite == jg.is_unibipartite
    assert tg.is_multigraph == jg.is_multigraph
    sub = [("user", "buys", "item")]
    assert (tg.edge_type_subgraph(sub).is_unibipartite
            == jg.edge_type_subgraph(sub).is_unibipartite is True)
    jb, tb = block_pair()
    for nt in (None, "_N"):
        assert tb.number_of_src_nodes(nt) == jb.number_of_src_nodes(nt)
        assert tb.number_of_dst_nodes(nt) == jb.number_of_dst_nodes(nt)
    assert tb.number_of_edges() == jb.number_of_edges()


def test_structure_facts_and_metagraph():
    pytest.importorskip("networkx")
    jg, tg = homo_pair()
    assert tg.is_multigraph is jg.is_multigraph is True
    js, ts = dgl_tpu.to_simple(jg), dt.to_simple(tg)
    assert ts.is_multigraph is js.is_multigraph is False
    for jx, tx in (hetero_pair(), (jg, tg)):
        jm, tm = jx.metagraph(), tx.metagraph()
        assert list(tm.nodes) == list(jm.nodes)
        assert list(tm.edges(keys=True)) == list(jm.edges(keys=True))
    assert tg.number_of_nodes() == jg.number_of_nodes()
    assert tg.get_ntype_id(None) == jg.get_ntype_id(None) == 0


# ---------------------------------------------------------------------------
# copies and views
# ---------------------------------------------------------------------------


def test_reverse_local_var_clone_cpu():
    for jg, tg in (homo_pair(), homo_pair(padded=True), hetero_pair()):
        for kw in ({}, {"copy_ndata": False}, {"copy_edata": False}):
            same_graph(tg.reverse(**kw), jg.reverse(**kw), "reverse")
        # (the reference's ``cpu()`` is a pytree round trip, which sorts
        # the edge and node types; the port keeps their order)
        for tv, jv in ((tg.local_var(), jg.local_var()),
                       (tg.clone(), jg.clone()), (tg.cpu(), jg)):
            same_graph(tv, jv)
        lv = tg.local_var()
        lv._node_frames[tg.ntypes[0]]["new"] = torch.zeros(1)
        assert "new" not in tg._node_frames[tg.ntypes[0]]
    jb, tb = block_pair()
    same_graph(tb.local_var(), jb.local_var(), "block local_var")


def test_astype_long_int():
    import jax

    jg, tg = homo_pair()
    gp = tg.with_spmm_plans(num_hubs=4)
    for g in (gp.long(), gp.astype(torch.int64)):
        rel = g._relation()
        assert all(getattr(rel, f).dtype == torch.int64
                   for f in rel.ARRAY_FIELDS)
        assert rel.hub_plan is None
        assert torch.equal(rel.csc_indices.int(),
                           tg._relation().csc_indices)
        assert g.idtype == torch.int64
    assert g.int().idtype == torch.int32
    same_graph(g.int(), jg.int())
    with jax.enable_x64(True):
        jl = jg.long()
        same_graph(tg.long(), jl)
    with pytest.raises(DGLError):
        tg.astype(torch.float32)


# ---------------------------------------------------------------------------
# frames and formats
# ---------------------------------------------------------------------------


def test_initializers_feed_add_nodes():
    jg, tg = homo_pair()
    jg.set_n_initializer(lambda shape, dtype: jnp.full(shape, 7.0, dtype),
                         field="x")
    tg.set_n_initializer(lambda shape, dtype: torch.full(shape, 7.0,
                                                         dtype=dtype),
                         field="x")
    jg.set_e_initializer(lambda shape, dtype: None)
    tg.set_e_initializer(lambda shape, dtype: None)
    assert tg._get_initializer("edge", "w", None) is not None
    same_graph(dt.add_nodes(tg, 3), dgl_tpu.add_nodes(jg, 3))
    assert float(tg.add_nodes(2).ndata["x"][-1, 0]) == 7.0


@pytest.mark.parametrize("fmts", [None, ["csc"], "csr", ["coo"],
                                  ["csr", "csc"]])
def test_formats(fmts):
    jg, tg = homo_pair(padded=True, frames=False)
    if fmts is None:
        assert tg.formats() == jg.formats()
        return
    jf, tf = jg.formats(fmts), tg.formats(fmts)
    assert tf.formats() == jf.formats()
    same_graph(tf, jf)
    for deg in ("in_degrees", "out_degrees"):
        try:
            ref = getattr(jf, deg)()
        except JDGLError:
            with pytest.raises(DGLError):
                getattr(tf, deg)()
            continue
        assert_same(getattr(tf, deg)(), ref)


# ---------------------------------------------------------------------------
# sparse matrices of a graph
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("padded", [False, True])
def test_adj_and_incidence(padded):
    jg, tg = homo_pair(padded)
    for ta, ja in ((tg.adj(), jg.adj()),
                   (tg.adjacency_matrix(), jg.adjacency_matrix()),
                   (tg.adjacency_matrix(transpose=True),
                    jg.adjacency_matrix(transpose=True))):
        assert ta.shape == ja.shape and ta.nnz == ja.nnz
        assert_same((ta.row, ta.col, ta.val), (ja.row, ja.col, ja.val))
        assert_same(ta.to_dense(), ja.to_dense())
    for typestr in ("in", "out", "both"):
        for ti, ji in ((tg.inc(typestr), jg.inc(typestr)),
                       (tg.incidence_matrix(typestr),
                        jg.incidence_matrix(typestr))):
            assert ti.shape == ji.shape
            assert_same((ti.row, ti.col, ti.val), (ji.row, ji.col, ji.val))
    jh, th = hetero_pair()
    ta, ja = th.adj(etype="has", eweight_name="w"), jh.adj(etype="has",
                                                          eweight_name="w")
    assert ta.shape == ja.shape == (7, 4)
    assert_same((ta.row, ta.col, ta.val), (ja.row, ja.col, ja.val))


# ---------------------------------------------------------------------------
# subgraph and filter methods, the transforms' method forms
# ---------------------------------------------------------------------------


def test_subgraph_methods():
    jg, tg = homo_pair(padded=True)
    nodes = np.array([7, 1, 3, 5, 10])
    same_graph(tg.subgraph(nodes), jg.subgraph(nodes))
    same_graph(tg.subgraph(nodes, store_ids=False),
               jg.subgraph(nodes, store_ids=False))
    eids = np.array([4, 0, 9, 33])
    for relabel in (True, False):
        same_graph(tg.edge_subgraph(eids, relabel_nodes=relabel),
                   jg.edge_subgraph(eids, relabel_nodes=relabel))
    jh, th = hetero_pair()
    same_graph(th.node_type_subgraph(["user", "item"]),
               jh.node_type_subgraph(["user", "item"]))
    same_graph(th.edge_type_subgraph(["has", "buys"]),
               jh.edge_type_subgraph(["has", "buys"]))
    assert_same(tg.filter_nodes(lambda nb: nb.data["x"][:, 0] > 0),
                jg.filter_nodes(lambda nb: nb.data["x"][:, 0] > 0))
    pred = (lambda eb: (eb.src["x"][:, 0] + eb.data["w"][:, 1]
                        > eb.dst["x"][:, 2]))
    assert_same(tg.filter_edges(pred), jg.filter_edges(pred))
    assert_same(th.filter_edges(lambda eb: eb.data["w"][:, 0] > 0,
                                etype="buys"),
                jh.filter_edges(lambda eb: eb.data["w"][:, 0] > 0,
                                etype="buys"))


@pytest.mark.parametrize("name,args", [
    ("add_self_loop", ()), ("remove_self_loop", ()), ("to_simple", ()),
    ("khop_graph", (2,)), ("line_graph", ()), ("add_nodes", (3,)),
    ("remove_nodes", (np.array([0, 4]),)),
    ("remove_edges", (np.array([1, 2, 30]),)),
    ("add_edges", (np.array([0, 11]), np.array([2, 2]))),
])
def test_transform_method_forms(name, args):
    jg, tg = homo_pair()
    ref = getattr(jg, name)(*args)
    same_graph(getattr(tg, name)(*args), ref, name)
    same_graph(getattr(dt, name)(tg, *args), ref, name)


def test_not_yet_ported_methods_raise():
    _, tg = homo_pair()
    for call in (lambda: tg.shared_memory("g"),
                 lambda: dt.hetero_from_shared_memory("g")):
        with pytest.raises(NotImplementedError, match="A12"):
            call()


# ---------------------------------------------------------------------------
# constructors
# ---------------------------------------------------------------------------


def _scipy_matrix(n=8, m=6, seed=4):
    return sps.random(n, m, density=0.35, format="csr", dtype=np.float32,
                      random_state=seed)


@pytest.mark.parametrize("seed", [0, 5])
def test_rand_graphs_draw_the_reference_graphs(seed):
    same_graph(dt.rand_graph(30, 90, seed=seed, device="cpu"),
               dgl_tpu.rand_graph(30, 90, seed=seed))
    same_graph(dt.rand_bipartite("u", "e", "v", 12, 9, 40, seed=seed,
                                 device="cpu"),
               dgl_tpu.rand_bipartite("u", "e", "v", 12, 9, 40, seed=seed))


def test_scipy_constructors():
    mat = _scipy_matrix()
    sq = _scipy_matrix(8, 8, 5)
    same_graph(dt.from_scipy(sq, device="cpu"), dgl_tpu.from_scipy(sq))
    same_graph(dt.from_scipy(mat, eweight_name="w", device="cpu"),
               dgl_tpu.from_scipy(mat, eweight_name="w"))
    for kw in ({}, {"eweight_name": "w"}):
        same_graph(dt.bipartite_from_scipy(mat, "u", "e", "v", device="cpu",
                                           **kw),
                   dgl_tpu.bipartite_from_scipy(mat, "u", "e", "v", **kw))


def test_block_to_graph():
    jb, tb = block_pair()
    same_graph(dt.block_to_graph(tb), dgl_tpu.block_to_graph(jb))


def test_networkx_round_trips():
    nx = pytest.importorskip("networkx")
    jg, tg = homo_pair()
    jn, tn = jg.to_networkx(node_attrs=["x"], edge_attrs=["w"]), \
        dt.to_networkx(tg, node_attrs=["x"], edge_attrs=["w"])
    assert list(tn.edges(keys=True, data="id")) == list(
        jn.edges(keys=True, data="id"))
    for u, v, k, d in jn.edges(keys=True, data=True):
        np.testing.assert_array_equal(tn.edges[u, v, k]["w"], d["w"])
    for i in jn.nodes:
        np.testing.assert_array_equal(tn.nodes[i]["x"], jn.nodes[i]["x"])
    gx = nx.karate_club_graph()
    for u, v in gx.edges():
        gx.edges[u, v]["wt"] = np.float32(u + v)
    for n_ in gx.nodes():
        gx.nodes[n_]["f"] = np.array([n_, 2 * n_], np.float32)
    same_graph(dt.from_networkx(gx, node_attrs=["f"], edge_attrs=["wt"],
                                device="cpu"),
               dgl_tpu.from_networkx(gx, node_attrs=["f"],
                                     edge_attrs=["wt"]))
    same_graph(dt.from_networkx(tn, device="cpu"),
               dgl_tpu.from_networkx(jn))
    bg = nx.Graph()
    bg.add_nodes_from(["a", "c", "b"], bipartite=0)
    bg.add_nodes_from([3, 1, 2, 0], bipartite=1)
    bg.add_edges_from([("a", 1), (2, "b"), ("c", 0), ("a", 3), ("b", 1)])
    same_graph(dt.bipartite_from_networkx(bg, "u", "e", "v", device="cpu"),
               dgl_tpu.bipartite_from_networkx(bg, "u", "e", "v"))
