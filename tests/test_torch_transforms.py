"""The port's structural transforms (``dgl_tpu_torch.transforms``) against
``dgl_tpu.transforms``, and the ``examples/gcn_cora.py`` recipe end to end.

Each transform runs on a homogeneous graph with multi-edges and
self-loops, on the same graph with padded edges, and on a graph of
several types where the reference takes one, all with node and edge
frames; the result's arrays (dtypes included), frames, batch sizes and the
``writeback_mapping``/``return_counts`` outputs must be equal.

The recipe: ``add_self_loop(remove_self_loop(g))``, then
``with_spmm_plans(weighted=True)`` and ``GCN(in, hidden, classes,
num_layers=3)`` on a 300-node graph, the reference's parameters carried
over by ``from_flax_params``; output and parameter gradients of
``sum(out * cot)``. The reference is compiled with XLA's
``xla_allow_excess_precision`` off so that it keeps the bf16 rounding of
its plan path, as the port does; the two then agree to f32 rounding, and
an element on a bf16 rounding boundary may round to neighbouring values on
the two sides: at most 1 element in 1000 outside rtol = atol = 1e-4, every
element within 2**-8 of max|ref|.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dgl_tpu
from dgl_tpu.base import DGLError as JDGLError
from dgl_tpu.models import GCN as JGCN
import dgl_tpu_torch as dt
from dgl_tpu_torch.base import DGLError
from dgl_tpu_torch.models import GCN
from test_torch_graph_utils import (assert_same, hetero_pair, homo_pair,
                                    np_of, same_graph, with_frames)


def self_hetero_pair():
    """Two node types, relations within and across them."""
    rng = np.random.default_rng(9)
    data = {("a", "to", "a"): (np.r_[rng.integers(0, 6, 14), 2, 2],
                               np.r_[rng.integers(0, 6, 14), 2, 4]),
            ("a", "x", "b"): (rng.integers(0, 6, 9), rng.integers(0, 5, 9)),
            ("b", "y", "a"): (rng.integers(0, 5, 7), rng.integers(0, 6, 7))}
    counts = {"a": 6, "b": 5}
    jg = dgl_tpu.heterograph(data, counts)
    tg = dt.heterograph(data, counts, device="cpu")
    return with_frames(jg, tg, seed=10)


GRAPHS = {"homo": lambda: homo_pair(),
          "padded": lambda: homo_pair(padded=True),
          "hetero": self_hetero_pair}


def _run(name, fn):
    """``fn(module, graph)`` on both sides; equal results, or both raise."""
    jg, tg = GRAPHS[name]()
    try:
        ref = fn(dgl_tpu, jg)
    except (JDGLError, ValueError, KeyError, IndexError) as exc:
        with pytest.raises(type(exc) if not isinstance(exc, JDGLError)
                           else DGLError):
            fn(dt, tg)
        return None
    got = fn(dt, tg)
    _same(got, ref)
    return got, ref


def _same(got, ref):
    if isinstance(ref, dgl_tpu.Graph):
        same_graph(got, ref)
    elif isinstance(ref, (tuple, list)):
        assert len(got) == len(ref)
        for a, b in zip(got, ref):
            _same(a, b)
    elif isinstance(ref, dict):
        assert set(got) == set(ref)
        for k in ref:
            _same(got[k], ref[k])
    else:
        assert_same(got, ref)


TRANSFORMS = {
    "add_self_loop": lambda m, g: m.add_self_loop(
        g, etype=g.canonical_etypes[0]),
    "add_self_loop_fill": lambda m, g: m.add_self_loop(
        g, edge_feat_names=["w"], fill_data=2.5,
        etype=g.canonical_etypes[0]),
    "add_self_loop_zero_fill": lambda m, g: m.add_self_loop(
        g, fill_data=None, etype=g.canonical_etypes[0]),
    "add_self_loop_bipartite": lambda m, g: m.add_self_loop(
        g, etype=g.canonical_etypes[-1]),
    "remove_self_loop": lambda m, g: m.remove_self_loop(
        g, etype=g.canonical_etypes[0]),
    "add_reverse_edges": lambda m, g: m.add_reverse_edges(
        g, etype=g.canonical_etypes[0]),
    "add_reverse_edges_copy": lambda m, g: m.add_reverse_edges(
        g, copy_edata=True, etype=g.canonical_etypes[0]),
    "add_edges": lambda m, g: m.add_edges(
        g, np.array([0, 1, 5]), np.array([2, 7, 1]),
        etype=g.canonical_etypes[0]),
    "add_edges_data": lambda m, g: m.add_edges(
        g, np.array([3, 0]), np.array([1, 1]),
        data={"w": np.ones((2, 2), np.float32),
              "new": np.full((2,), 4.0, np.float32)},
        etype=g.canonical_etypes[0]),
    "remove_edges": lambda m, g: m.remove_edges(
        g, np.array([0, 3, 7]), etype=g.canonical_etypes[0]),
    "remove_edges_store": lambda m, g: m.remove_edges(
        g, np.array([1, 2]), etype=g.canonical_etypes[-1], store_ids=True),
    "add_nodes": lambda m, g: m.add_nodes(g, 3, ntype=g.ntypes[0]),
    "add_nodes_data": lambda m, g: m.add_nodes(
        g, 2, data={"x": np.ones((2, 3), np.float32),
                    "y": np.arange(2, dtype=np.float32)},
        ntype=g.ntypes[-1]),
    "remove_nodes": lambda m, g: m.remove_nodes(g, np.array([0, 4]),
                                                ntype=g.ntypes[0]),
    "remove_nodes_store": lambda m, g: m.remove_nodes(
        g, np.array([1]), ntype=g.ntypes[-1], store_ids=True),
    "to_simple": lambda m, g: m.to_simple(g),
    "to_simple_mapping": lambda m, g: m.to_simple(
        g, return_counts="cnt", writeback_mapping=True, copy_ndata=False),
    "to_simple_no_counts": lambda m, g: m.to_simple(g, return_counts=None),
    "to_simple_graph": lambda m, g: m.to_simple_graph(g),
    "reverse": lambda m, g: m.reverse(g),
    "reverse_no_edata": lambda m, g: m.reverse(g, copy_edata=False),
    "compact_graphs": lambda m, g: m.compact_graphs(
        m.remove_edges(g, np.arange(10), etype=g.canonical_etypes[0])),
    "compact_graphs_list": lambda m, g: m.compact_graphs(
        [m.remove_edges(g, np.arange(20), etype=g.canonical_etypes[0]),
         m.remove_edges(g, np.arange(5, 30), etype=g.canonical_etypes[0])],
        always_preserve={g.ntypes[0]: np.array([0, 1])}),
    "to_block": lambda m, g: m.to_block(g),
    "to_block_dst": lambda m, g: m.to_block(
        g, {nt: np.array([3, 0, 2]) for nt in g.ntypes}),
    "to_block_no_dst_in_src": lambda m, g: m.to_block(
        g, {nt: np.array([1, 4]) for nt in g.ntypes},
        include_dst_in_src=False),
    "to_block_duplicate_dst_raises": lambda m, g: m.to_block(
        g, {nt: np.array([1, 1]) for nt in g.ntypes}),
    "norm_by_dst": lambda m, g: m.norm_by_dst(g, g.canonical_etypes[0]),
    "update_graph_structure": lambda m, g: m.update_graph_structure(
        g, {g.canonical_etypes[0]: (np.array([0, 1, 2]),
                                    np.array([2, 1, 0]))}),
    "update_graph_structure_no_edata": lambda m, g: m.update_graph_structure(
        g, {g.canonical_etypes[0]: (np.array([0, 5]), np.array([5, 5]))},
        copy_edata=False),
}
HOMO_ONLY = {
    "to_bidirected": lambda m, g: m.to_bidirected(g),
    "to_bidirected_ndata": lambda m, g: m.to_bidirected(g, copy_ndata=True),
    "khop_adj": lambda m, g: m.khop_adj(g, 3),
    "khop_graph": lambda m, g: m.khop_graph(g, 2),
    "line_graph": lambda m, g: m.line_graph(g),
    "line_graph_no_backtracking": lambda m, g: m.line_graph(
        g, backtracking=False),
    "is_bidirected": lambda m, g: (m.is_bidirected(g),
                                   m.is_bidirected(m.to_bidirected(g))),
}


@pytest.mark.parametrize("graph", sorted(GRAPHS))
@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_transform_matches(name, graph):
    _run(graph, TRANSFORMS[name])


@pytest.mark.parametrize("graph", ["homo", "padded"])
@pytest.mark.parametrize("name", sorted(HOMO_ONLY))
def test_homogeneous_transform_matches(name, graph):
    _run(graph, HOMO_ONLY[name])


def test_to_bidirected_drops_frames_and_plans():
    _, tg = homo_pair()
    gp = tg.with_spmm_plans(num_hubs=4)
    out = dt.to_bidirected(gp)
    assert out._relation().hub_plan is None
    assert not out.ndata and not out.edata and not out.dstdata
    assert dt.to_bidirected(gp, copy_ndata=True).ndata["x"] is tg.ndata["x"]
    # _rebuild keeps the node frames, drops every plan of the new relation
    g2 = dt.add_self_loop(gp)
    assert g2._relation().hub_plan is None and g2.ndata["x"] is tg.ndata["x"]


def test_to_simple_hetero_mapping():
    jg, tg = hetero_pair()
    (tout, twb), (jout, jwb) = (
        dt.to_simple(tg, writeback_mapping=True),
        dgl_tpu.to_simple(jg, writeback_mapping=True))
    same_graph(tout, jout)
    _same(twb, jwb)


def test_to_block_hetero_types():
    jg, tg = hetero_pair()
    for dst in (None, {"user": np.array([2, 0]), "tag": np.array([1])}):
        same_graph(dt.to_block(tg, dst), dgl_tpu.to_block(jg, dst))


@pytest.mark.parametrize("cast,dtype", [
    ("to_float", torch.float32), ("to_double", torch.float64),
    ("to_half", torch.float16), ("to_bfloat16", torch.bfloat16)])
def test_frame_casts(cast, dtype):
    jg, tg = homo_pair()
    ids = np.arange(tg.num_nodes(), dtype=np.int32)
    tg.ndata["ids"], jg.ndata["ids"] = torch.from_numpy(ids), jnp.asarray(ids)
    with jax.enable_x64(cast == "to_double"):
        ref = getattr(dgl_tpu, cast)(jg)
        out = getattr(dt, cast)(tg)
        for tf, jf in ((out.ndata, ref.ndata), (out.edata, ref.edata)):
            for k in jf:
                assert np.dtype(str(tf[k].dtype).split(".")[-1]) == \
                    np.dtype(jf[k].dtype), k
                np.testing.assert_array_equal(
                    tf[k].float().numpy() if tf[k].is_floating_point()
                    else tf[k].numpy(),
                    np.asarray(jf[k]).astype(np.float32)
                    if tf[k].is_floating_point() else np.asarray(jf[k]))
    assert tg.ndata["x"].dtype == torch.float32  # the input is untouched
    assert out.ndata["ids"].dtype == torch.int32


def test_add_nodes_initializer_and_grown_counts():
    jg, tg = self_hetero_pair()
    for g in (jg, tg):
        g.set_n_initializer((lambda s, d: jnp.full(s, -1.0, d)) if g is jg
                            else (lambda s, d: torch.full(s, -1.0, dtype=d)),
                            field="x", ntype="b")
    same_graph(dt.add_nodes(tg, 2, ntype="b"),
               dgl_tpu.add_nodes(jg, 2, ntype="b"))
    # add_edges grows both node counts of a same-type relation
    same_graph(dt.add_edges(tg, [9], [1], etype="to"),
               dgl_tpu.add_edges(jg, [9], [1], etype="to"))


def test_khop_and_line_graph_frames():
    jg, tg = homo_pair()
    for fn in (lambda m, g: m.khop_graph(g, 3),
               lambda m, g: m.line_graph(m.to_simple(g))):
        same_graph(fn(dt, tg), fn(dgl_tpu, jg))


# ---------------------------------------------------------------------------
# the gcn_cora.py recipe, end to end
# ---------------------------------------------------------------------------


def _bf16_close(got, ref, what):
    scale = max(float(np.abs(ref).max()), 1e-30)
    bad = np.abs(got - ref) > 1e-4 * scale + 1e-4 * np.abs(ref)
    assert bad.mean() <= 1e-3, f"{what}: {bad.sum()} of {bad.size}"
    np.testing.assert_allclose(got, ref, rtol=0, atol=2.0 ** -8 * scale,
                               err_msg=what)


def test_gcn_recipe_matches_reference():
    n, e, feats, hidden, classes = 300, 2400, 16, 32, 5
    rng = np.random.default_rng(11)
    w = 1.0 / np.arange(1, n + 1)
    src = rng.choice(n, e, p=w / w.sum())
    dst = rng.integers(0, n, e)
    src = np.r_[src, 7, 9]
    dst = np.r_[dst, 7, 9]
    kw = dict(num_hubs=32, weighted=True)
    jg = dgl_tpu.add_self_loop(dgl_tpu.remove_self_loop(
        dgl_tpu.graph((src, dst), num_nodes=n))).with_spmm_plans(**kw)
    tg = dt.add_self_loop(dt.remove_self_loop(
        dt.graph((src, dst), num_nodes=n, device="cpu"))).with_spmm_plans(
            **kw)
    same_graph(tg, jg)
    assert tg._relation().hub_plan is not None
    assert tg._relation().shell_plan is not None
    x = rng.normal(size=(n, feats)).astype(np.float32)
    cot = rng.normal(size=(n, classes)).astype(np.float32)
    jm = JGCN(feats, hidden, classes, num_layers=3, dropout=0.0)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jg, jnp.asarray(x))

    def both(p, xx):
        out, pull = jax.vjp(lambda q: jm.apply(q, jg, xx), p)
        return out, pull(jnp.asarray(cot))[0]

    compiled = jax.jit(both).lower(params, jnp.asarray(x)).compile(
        compiler_options={"xla_allow_excess_precision": False})
    jout, jgrads = compiled(params, jnp.asarray(x))
    tm = GCN(feats, hidden, classes, num_layers=3, dropout=0.0,
             device="cpu")
    tm.load_state_dict(dt.from_flax_params(params))
    out = tm(tg, torch.from_numpy(x))
    out.backward(torch.from_numpy(cot))
    _bf16_close(np_of(out), np.asarray(jout), "output")
    ref = dt.from_flax_params(jgrads)
    for name, p in tm.named_parameters():
        _bf16_close(np_of(p.grad), ref[name].numpy(), name)
