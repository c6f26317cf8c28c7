"""The port's heterogeneous graphs against ``dgl_tpu``: the graph's schema,
counts, data views and errors; ``heterograph``, ``create_block`` between
node types, ``to_homogeneous`` and ``to_heterogeneous``; the per-relation
plans of ``with_spmm_plans``; ``multi_update_all`` with each cross reducer,
``pull``, ``push`` and ``send_and_recv`` (builtin and UDF reducers); and
``HeteroGraphConv`` with each aggregate.

The graph is the reference's ogbn-mag-shaped generator at its defaults
(2,000 papers, 1,200 authors, 100 institutions, 200 fields, 19,500 edges
over 4 relations, numpy seed 0); the port's graph is built from the
reference's own edge arrays, and every input is made with numpy from a
seed. ``HeteroGraphConv``'s reference runs under ``jax.jit``; the core
operations run eagerly, as ``tests/test_core.py`` runs them (their edge
ids are host data).

Tolerances: index arrays, counts and plans exact; f32 values rtol = atol =
1e-5 (the same f32 operations, sums in other orders).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dgl_tpu
import dgl_tpu.function as jfn
from dgl_tpu.data.synthetic import synthetic_hetero_graph
from dgl_tpu.nn import HeteroGraphConv as JHeteroGraphConv
from dgl_tpu.nn.conv import GraphConv as JGraphConv
import dgl_tpu_torch as dt
import dgl_tpu_torch.function as tfn
from dgl_tpu_torch.nn import GraphConv, HeteroGraphConv

TOL = dict(rtol=1e-5, atol=1e-5)
F = 6


def _port_of(jg, device="cpu"):
    """The port's heterograph on the reference graph's edge arrays."""
    data = {cet: (np.asarray(jg._relations[cet].src),
                  np.asarray(jg._relations[cet].dst))
            for cet in jg.canonical_etypes}
    return dt.heterograph(data, {nt: jg.num_nodes(nt) for nt in jg.ntypes},
                          device=device)


@pytest.fixture(scope="module")
def mag():
    jg = synthetic_hetero_graph()
    return jg, _port_of(jg)


def _feats(g_or_counts, seed, f=F):
    rng = np.random.default_rng(seed)
    return {nt: rng.normal(size=(n, f)).astype(np.float32)
            for nt, n in g_or_counts.items()}


def _counts(jg):
    return {nt: jg.num_nodes(nt) for nt in jg.ntypes}


def _assert_relations_equal(trel, jrel):
    assert (trel.num_src, trel.num_dst, trel.num_edges) == (
        jrel.num_src, jrel.num_dst, jrel.num_edges)
    for f in dt.Relation.ARRAY_FIELDS:
        np.testing.assert_array_equal(getattr(trel, f).numpy(),
                                      np.asarray(getattr(jrel, f)))


# ---------------------------------------------------------------------------
# the graph: schema, counts, views, errors
# ---------------------------------------------------------------------------


def test_schema_and_counts(mag):
    jg, tg = mag
    assert tg.ntypes == jg.ntypes
    assert tg.canonical_etypes == jg.canonical_etypes
    assert tg.etypes == jg.etypes
    assert tg.srctypes == jg.srctypes and tg.dsttypes == jg.dsttypes
    assert not tg.is_homogeneous and not tg.is_block
    assert tg.num_nodes() == jg.num_nodes() == 3500
    assert tg.num_edges() == jg.num_edges() == 19_500
    for nt in jg.ntypes:
        assert (tg.num_nodes(nt), tg.num_src_nodes(nt),
                tg.num_dst_nodes(nt)) == (jg.num_nodes(nt),
                                          jg.num_src_nodes(nt),
                                          jg.num_dst_nodes(nt))
    for cet in jg.canonical_etypes:
        et = cet[1]
        assert tg.to_canonical_etype(et) == cet
        assert tg.num_edges(et) == jg.num_edges(et)
        _assert_relations_equal(tg._relation(et), jg._relation(et))
        for deg in ("in_degrees", "out_degrees"):
            np.testing.assert_array_equal(
                getattr(tg, deg)(etype=et).numpy(),
                np.asarray(getattr(jg, deg)(etype=et)))
        np.testing.assert_array_equal(
            getattr(tg, "in_degrees")([0, 3], etype=cet).numpy(),
            np.asarray(jg.in_degrees(jnp.asarray([0, 3]), etype=cet)))
        for a, b in zip(tg.edges(form="all", etype=et),
                        jg.edges(form="all", etype=et)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        np.testing.assert_array_equal(tg.edges("eid", etype=et).numpy(),
                                      np.asarray(jg.edges("eid", etype=et)))
    assert tg.idtype == torch.int32


def test_canonical_etype_errors():
    data = {("a", "r", "b"): (np.array([0, 1]), np.array([1, 0])),
            ("b", "r", "a"): (np.array([0]), np.array([1])),
            ("a", "s", "a"): (np.array([1]), np.array([0]))}
    jg = dgl_tpu.heterograph(data, {"a": 2, "b": 2})
    tg = dt.heterograph(data, {"a": 2, "b": 2}, device="cpu")
    for g, err in ((jg, dgl_tpu.DGLError), (tg, dt.DGLError)):
        with pytest.raises(err, match="must be specified"):
            g.to_canonical_etype(None)
        with pytest.raises(err, match="ambiguous"):
            g.to_canonical_etype("r")
        with pytest.raises(err, match="Unknown edge type"):
            g.to_canonical_etype("t")
        with pytest.raises(err, match="Unknown canonical etype"):
            g.to_canonical_etype(("b", "s", "b"))
        assert g.to_canonical_etype("s") == ("a", "s", "a")
        assert g.num_edges() == 4
        with pytest.raises(err):
            g.num_nodes("c")
    with pytest.raises(dt.DGLError, match="Unknown node type"):
        dt.Graph({("a", "r", "c"): tg._relation(("a", "r", "b"))},
                 {"a": 2, "b": 2})


def test_data_views(mag):
    jg, tg = mag
    x = _feats(_counts(jg), 1)
    with pytest.raises(dt.DGLError, match="multiple node types"):
        tg.ndata["feat"]
    with pytest.raises(dt.DGLError, match="dict of per-type"):
        tg.ndata["h"] = torch.zeros(2000, F)
    with pytest.raises(dt.DGLError, match="multiple edge types"):
        tg.edata["w"]
    with tg.local_scope():
        tg.ndata["h"] = {nt: torch.from_numpy(v) for nt, v in x.items()}
        tg.edata["w"] = {cet: torch.ones(tg.num_edges(cet))
                         for cet in tg.canonical_etypes}
        tg.nodes["paper"].data["p"] = torch.zeros(2000)
        tg.edges_view["cites"].data["c"] = torch.zeros(8000, 2)
        for nt in tg.ntypes:
            assert tg.nodes[nt].data["h"].shape == (tg.num_nodes(nt), F)
        assert set(tg.nodes["paper"].data) == {"h", "p"}
        assert set(tg.edges_view["cites"].data) == {"w", "c"}
        with pytest.raises(dt.DGLError, match="nodes 1200"):
            tg.nodes["author"].data["bad"] = torch.zeros(5)
        with pytest.raises(dt.DGLError, match="number of edges 6000"):
            tg.edges_view["writes"].data["bad"] = torch.zeros(5)
    # local_scope restores every type's frames
    assert "h" not in tg.nodes["author"].data
    assert "w" not in tg.edges_view["has_topic"].data
    assert "p" not in tg.nodes["paper"].data
    # one type of its role: the plain frame, as the reference's views
    b = dt.create_block({("author", "writes", "paper"): (
        np.array([0, 2]), np.array([1, 1]))}, {"author": 3}, {"paper": 2},
        device="cpu")
    b.srcdata["h"] = torch.ones(3, 2)
    b.dstdata["h"] = torch.zeros(2, 2)
    assert b.srcdata["h"].shape == (3, 2) and b.dstdata["h"].shape == (2, 2)
    assert b.ntypes == ["author", "paper"]
    with pytest.raises(dt.DGLError, match="multiple node types"):
        b.ndata["h"]


# ---------------------------------------------------------------------------
# convert
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("counts", [True, False])
def test_heterograph_matches_reference(counts):
    rng = np.random.default_rng(3)
    data = {("user", "follows", "user"): (rng.integers(0, 40, 300),
                                          rng.integers(0, 35, 300)),
            ("user", "rates", "item"): (rng.integers(0, 38, 200),
                                        rng.integers(0, 25, 200)),
            ("item", "rated_by", "user"): (np.zeros(0, np.int64),
                                           np.zeros(0, np.int64))}
    nn = {"user": 41, "item": 26} if counts else None
    jg = dgl_tpu.heterograph(data, nn)
    tg = dt.heterograph(data, nn, device="cpu")
    assert tg.ntypes == jg.ntypes
    for nt in jg.ntypes:
        assert tg.num_nodes(nt) == jg.num_nodes(nt)
    for cet in jg.canonical_etypes:
        _assert_relations_equal(tg._relations[cet], jg._relations[cet])


def test_block_between_node_types_matches_reference():
    rng = np.random.default_rng(4)
    data = {("author", "writes", "paper"): (rng.integers(0, 30, 90),
                                            rng.integers(0, 12, 90)),
            ("paper", "cites", "paper"): (rng.integers(0, 20, 70),
                                          rng.integers(0, 12, 70))}
    src_n, dst_n = {"author": 30, "paper": 20}, {"paper": 12}
    ne = {("paper", "cites", "paper"): 64}
    padded = dict(data)
    s, d = data[("paper", "cites", "paper")]
    padded[("paper", "cites", "paper")] = (np.where(np.arange(70) < 64, s, 20),
                                           np.where(np.arange(70) < 64, d, 12))
    jb = dgl_tpu.create_block(padded, src_n, dst_n, num_edges=ne)
    tb = dt.create_block(padded, src_n, dst_n, num_edges=ne, device="cpu")
    assert tb.is_block and tb.ntypes == jb.ntypes == ["author", "paper"]
    assert tb.srctypes == jb.srctypes and tb.dsttypes == jb.dsttypes
    assert (tb.num_src_nodes(), tb.num_dst_nodes()) == (
        jb.num_src_nodes(), jb.num_dst_nodes()) == (50, 12)
    for cet in jb.canonical_etypes:
        _assert_relations_equal(tb._relations[cet], jb._relations[cet])
    inferred_j = dgl_tpu.create_block(data)
    inferred_t = dt.create_block(data, device="cpu")
    for nt in inferred_j.srctypes:
        assert inferred_t.num_src_nodes(nt) == inferred_j.num_src_nodes(nt)
    for nt in inferred_j.dsttypes:
        assert inferred_t.num_dst_nodes(nt) == inferred_j.num_dst_nodes(nt)


def test_to_homogeneous_and_back(mag):
    jg, tg = mag
    x = _feats(_counts(jg), 2)
    w = {cet: np.random.default_rng(i).normal(
        size=jg.num_edges(cet)).astype(np.float32)
        for i, cet in enumerate(jg.canonical_etypes)}
    jg2, tg2 = jg.local_var(), tg
    with tg.local_scope():
        for nt in jg.ntypes:
            jg2._node_frames.setdefault(nt, {})["x"] = jnp.asarray(x[nt])
            tg2.nodes[nt].data["x"] = torch.from_numpy(x[nt])
        for cet in jg.canonical_etypes:
            jg2._edge_frames.setdefault(cet, {})["w"] = jnp.asarray(w[cet])
            tg2.edges_view[cet].data["w"] = torch.from_numpy(w[cet])
        jh = dgl_tpu.to_homogeneous(jg2, ndata=["x"], edata=["w"])
        th = dt.to_homogeneous(tg2, ndata=["x"], edata=["w"])
    assert th.num_nodes() == jh.num_nodes() and th.is_homogeneous
    _assert_relations_equal(th._relation(), jh._relation())
    for key in (dt.NTYPE, dt.NID, "x"):
        np.testing.assert_array_equal(th.ndata[key].numpy(),
                                      np.asarray(jh.ndata[key]))
    for key in (dt.ETYPE, dt.EID, "w"):
        np.testing.assert_array_equal(th.edata[key].numpy(),
                                      np.asarray(jh.edata[key]))
    jb = dgl_tpu.to_heterogeneous(jh, jg.ntypes, jg.etypes)
    tb = dt.to_heterogeneous(th, tg.ntypes, tg.etypes)
    assert tb.canonical_etypes == jb.canonical_etypes == tg.canonical_etypes
    for nt in jb.ntypes:
        assert tb.num_nodes(nt) == jb.num_nodes(nt) == tg.num_nodes(nt)
    for cet in jb.canonical_etypes:
        _assert_relations_equal(tb._relations[cet], jb._relations[cet])
        _assert_relations_equal(tb._relations[cet], tg._relations[cet])


def test_with_spmm_plans_per_relation(mag):
    """Hub plans on every relation, bipartite ones included, array for
    array (the oracle of ``tests/test_shell_spmm.py:202``); the bitmap and
    dense gates decided per relation as the reference decides them."""
    jg, tg = mag
    jp, tp = jg.with_spmm_plans(num_hubs=128), tg.with_spmm_plans(
        num_hubs=128)
    for cet in jg.canonical_etypes:
        jr, tr = jp._relations[cet], tp._relations[cet]
        assert (tr.bitmap_plan is None) == (jr.bitmap_plan is None)
        assert (tr.dense_adj is None) == (jr.dense_adj is None)
        j, t = jr.hub_plan, tr.hub_plan
        assert (t.num_src, t.num_dst) == (tr.num_src, tr.num_dst)
        assert (t.num_hubs, t.precision, t.coverage) == (
            j.num_hubs, j.precision, j.coverage)
        np.testing.assert_array_equal(t.hub_ids.numpy(), np.asarray(j.hub_ids))
        assert tuple(t.a_hub.shape) == (tr.num_dst, t.num_hubs)
        np.testing.assert_array_equal(t.a_hub.numpy(), np.asarray(j.a_hub))
        for tsh, jsh in ((t.shells, j.shells), (t.rev_shells, j.rev_shells)):
            assert len(tsh) == len(jsh) > 0
            for (ti, tm), (ji, jm) in zip(tsh, jsh):
                np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
                np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
        for tres, jres in ((t.res_dst, j.res_dst), (t.res_src, j.res_src),
                           (t.unrank_dst, j.unrank_dst),
                           (t.unrank_src, j.unrank_src)):
            assert (tres is None) == (jres is None)
            if jres is not None:
                for ta, ja in zip(tres if isinstance(tres, tuple) else [tres],
                                  jres if isinstance(jres, tuple) else [jres]):
                    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    # every mag relation has multi-edges: no bitmap, no dense mask
    assert all(r.bitmap_plan is None and r.dense_adj is None
               for r in tp._relations.values())
    # the gates per relation: a dense simple relation takes both, a sparse
    # one over 16M cells neither, a multigraph neither
    rng = np.random.default_rng(8)

    def pairs(ns, nd, e, unique=True):
        if not unique:
            return rng.integers(0, ns, e), rng.integers(0, nd, e)
        key = rng.choice(ns * nd, e, replace=False)
        return key // nd, key % nd

    data = {("a", "x", "b"): pairs(50, 60, 600),
            ("c", "y", "d"): pairs(5000, 4000, 2000),
            ("a", "z", "d"): pairs(50, 4000, 3000, unique=False)}
    nn = {"a": 50, "b": 60, "c": 5000, "d": 4000}
    jp = dgl_tpu.heterograph(data, nn).with_spmm_plans(num_hubs=16)
    tp = dt.heterograph(data, nn, device="cpu").with_spmm_plans(num_hubs=16)
    got = {cet[1]: (r.bitmap_plan is not None, r.dense_adj is not None)
           for cet, r in tp._relations.items()}
    assert got == {cet[1]: (r.bitmap_plan is not None,
                            r.dense_adj is not None)
                   for cet, r in jp._relations.items()}
    assert got == {"x": (True, True), "y": (False, False),
                   "z": (False, False)}


# ---------------------------------------------------------------------------
# core: multi_update_all, pull, push, send_and_recv
# ---------------------------------------------------------------------------


def _set_feats(jg, tg, x, field="h"):
    for nt, v in x.items():
        jg.nodes[nt].data[field] = jnp.asarray(v)
        tg.nodes[nt].data[field] = torch.from_numpy(v)


def _frames_close(jg, tg, field, ntypes):
    for nt in ntypes:
        np.testing.assert_allclose(tg.nodes[nt].data[field].numpy(),
                                   np.asarray(jg.nodes[nt].data[field]),
                                   **TOL)


@pytest.mark.parametrize("cross", ["sum", "max", "min", "mean", "stack"])
def test_multi_update_all(mag, cross):
    jg0, tg0 = mag
    jg, tg = jg0.local_var(), tg0.structural_clone()
    with tg.local_scope():
        x = _feats(_counts(jg), 5)
        _set_feats(jg, tg, x)
        spec = {"cites": "sum", "writes": "mean", "affiliated_with": "max",
                "has_topic": "min"}
        for g, fn in ((jg, jfn), (tg, tfn)):
            g.multi_update_all(
                {et: (fn.copy_u("h", "m"), getattr(fn, red)("m", "o"))
                 for et, red in spec.items()}, cross,
                apply_node_func=lambda nodes: {"o2": nodes.data["o"] * 2})
        # paper takes two relations; institution and field one each;
        # author none
        _frames_close(jg, tg, "o", ["paper", "institution", "field"])
        _frames_close(jg, tg, "o2", ["paper", "institution", "field"])
        assert "o" not in tg.nodes["author"].data
        if cross == "stack":
            assert tg.nodes["paper"].data["o"].shape == (2000, 2, F)
            assert tg.nodes["field"].data["o"].shape == (200, 1, F)
        with pytest.raises(dt.DGLError, match="cross reducer"):
            tg.multi_update_all({"cites": (tfn.copy_u("h", "m"),
                                           tfn.sum("m", "o")),
                                 "writes": (tfn.copy_u("h", "m"),
                                            tfn.sum("m", "o"))}, "prod")


def test_pull_and_push(mag):
    jg0, tg0 = mag
    jg, tg = jg0.local_var(), tg0.structural_clone()
    with tg.local_scope():
        _set_feats(jg, tg, _feats(_counts(jg), 6))
        rows = np.array([0, 7, 1999, 7, 55])
        for g, fn in ((jg, jfn), (tg, tfn)):
            # pull: a field the frame lacks takes the whole reduce, one it
            # holds only its rows
            g.pull(rows, fn.copy_u("h", "m"), fn.sum("m", "h"),
                   etype="writes")
            g.pull(rows[:2], fn.u_add_v("h", "h", "m"), fn.max("m", "q"),
                   apply_node_func=lambda nodes: {"q1": nodes.data["q"] + 1},
                   etype="cites")
            g.push(np.array([3, 4, 600]), fn.copy_u("h", "m"),
                   fn.sum("m", "s"), etype="writes")
        _frames_close(jg, tg, "h", jg.ntypes)
        _frames_close(jg, tg, "q", ["paper"])
        _frames_close(jg, tg, "q1", ["paper"])
        _frames_close(jg, tg, "s", ["paper"])


@pytest.mark.parametrize("red", ["sum", "mean", "max", "min", "udf"])
def test_send_and_recv(mag, red):
    jg0, tg0 = mag
    jg, tg = jg0.local_var(), tg0.structural_clone()
    eids = np.array([0, 5, 9, 9, 20, 33, 4000, 5999, 1200])
    with tg.local_scope():
        _set_feats(jg, tg, _feats(_counts(jg), 7))
        # an existing "o" on paper: only the reached rows are replaced
        base = np.full((2000, F), 3.0, np.float32)
        jg.nodes["paper"].data["o"] = jnp.asarray(base)
        tg.nodes["paper"].data["o"] = torch.from_numpy(base)

        def udf(nodes):
            m = nodes.mailbox["m"]
            mask = nodes.mailbox_mask[..., None]
            return {"o": (m * m * mask).sum(1)}

        outs = []
        for g, fn in ((jg, jfn), (tg, tfn)):
            reducer = udf if red == "udf" else getattr(fn, red)("m", "o")
            outs.append(g.send_and_recv(
                eids, lambda edges: {"m": edges.src["h"] * 2.0}, reducer,
                apply_node_func=lambda nodes: {"o3": nodes.data["o"] * 3},
                etype="writes"))
        np.testing.assert_allclose(outs[1]["o"].numpy(),
                                   np.asarray(outs[0]["o"]), **TOL)
        _frames_close(jg, tg, "o", ["paper"])
        _frames_close(jg, tg, "o3", ["paper"])


def test_send_and_recv_nonfinite_to_zero():
    """Max and min give 0 where the result is not finite: rows the subset
    misses and infinite messages (a divergence from DGL, shared with the
    reference; ROADMAP queue C)."""
    src, dst = np.array([0, 1, 2, 3]), np.array([1, 1, 2, 0])
    jg = dgl_tpu.graph((src, dst), num_nodes=4)
    tg = dt.graph((src, dst), num_nodes=4, device="cpu")
    h = np.array([[1.0], [-np.inf], [np.inf], [2.0]], np.float32)
    jg.ndata["h"], tg.ndata["h"] = jnp.asarray(h), torch.from_numpy(h)
    for red in ("max", "min"):
        j = jg.send_and_recv([0, 1, 2], jfn.copy_u("h", "m"),
                             getattr(jfn, red)("m", red))[red]
        t = tg.send_and_recv([0, 1, 2], tfn.copy_u("h", "m"),
                             getattr(tfn, red)("m", red))[red]
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
        assert np.isfinite(t.numpy()).all()


# ---------------------------------------------------------------------------
# HeteroGraphConv
# ---------------------------------------------------------------------------


def _jit_apply(module, params, g, inputs):
    return jax.jit(lambda p, x: module.apply(p, g, x))(
        params, {k: jnp.asarray(v) for k, v in inputs.items()})


@pytest.mark.parametrize("aggregate", ["sum", "max", "min", "mean", "stack"])
def test_heterographconv_matches(mag, aggregate):
    """All relations but ``has_topic`` have a module (a skipped relation);
    ``author`` gets no input and ``field`` no module, so ``writes`` and
    ``affiliated_with`` are skipped and only ``paper`` comes out."""
    jg, tg = mag
    mods = ("cites", "writes", "affiliated_with")
    jconv = JHeteroGraphConv(
        {et: JGraphConv(F, 4, allow_zero_in_degree=True) for et in mods},
        aggregate=aggregate)
    tconv = HeteroGraphConv(
        {et: GraphConv(F, 4, allow_zero_in_degree=True, device="cpu")
         for et in mods}, aggregate=aggregate)
    x = _feats(_counts(jg), 8)
    params = jconv.init(jax.random.PRNGKey(0), jg,
                        {k: jnp.asarray(v) for k, v in x.items()})
    # flax names a HeteroGraphConv's modules mods_<etype>
    tconv.load_state_dict(dt.from_flax_params(
        params, rename={f"mods_{et}": f"mods.{et}" for et in mods}))
    inputs = {nt: x[nt] for nt in ("paper", "institution")}
    ref = _jit_apply(jconv, params, jg, inputs)
    out = tconv(tg, {k: torch.from_numpy(v) for k, v in inputs.items()})
    assert set(out) == set(ref) == {"paper"}
    np.testing.assert_allclose(out["paper"].detach().numpy(),
                               np.asarray(ref["paper"]), **TOL)
    # every input: paper from cites and writes, institution from
    # affiliated_with; field absent (no module)
    ref = _jit_apply(jconv, params, jg, x)
    out = tconv(tg, {k: torch.from_numpy(v) for k, v in x.items()})
    assert set(out) == set(ref) == {"paper", "institution"}
    for k in ref:
        np.testing.assert_allclose(out[k].detach().numpy(),
                                   np.asarray(ref[k]), **TOL)
    if aggregate == "stack":
        assert out["paper"].shape == (2000, 2, 4)


def test_heterogeneous_sampling_raises(mag):
    """The homogeneous samplers take one relation: on a graph of several
    edge types they raise ``DGLError`` resolving it, as the reference
    does (``HeteroFixedShapeNeighborSampler`` samples such graphs)."""
    _, tg = mag
    with pytest.raises(dt.DGLError, match="multiple edge types"):
        dt.dataloading.FixedShapeNeighborSampler([2], 4).sample_blocks(
            tg, np.array([0, 1]))
    with pytest.raises(dt.DGLError, match="multiple edge types"):
        dt.sampling.DeviceNeighborSampler([2]).sample_from(
            torch.Generator(), tg, torch.tensor([0, 1]))


def test_heterographconv_errors_and_params():
    with pytest.raises(dt.DGLError, match="aggregate"):
        HeteroGraphConv({}, aggregate="prod")
    conv = HeteroGraphConv({"rates": GraphConv(3, 2, device="cpu")})
    assert set(conv.state_dict()) == {"mods.rates.weight", "mods.rates.bias"}
    tree = {"params": {"l0_rates": {"weight": np.ones((3, 2)),
                                    "bias": np.zeros(2)}}}
    assert set(dt.from_flax_params(tree)) == {"l0_rates.weight",
                                              "l0_rates.bias"}
    conv.load_state_dict(dt.from_flax_params(
        tree, rename={"l0_rates": "mods.rates"}))
    assert conv.mods["rates"].weight.sum().item() == 6.0
