"""The port's traversal generators, ordered propagation and geometry
(``dgl_tpu_torch.traversal``, ``propagate``, ``geometry``) against
``dgl_tpu``'s.

- The five generators on a random graph with cycles, multi-edges and
  self-loops, its padded copy, a DAG, a forest of random trees and a graph
  with isolated nodes, forwards and reversed, from several sources: the
  frontiers (host numpy) must be equal, array for array; topological order
  on a cyclic graph raises on both sides.
- ``prop_nodes_bfs``, ``prop_nodes_topo``, ``prop_edges_dfs``,
  ``prop_nodes``/``prop_edges`` and the ``Graph`` methods with builtin and
  user-defined message and reduce functions and an apply function, and the
  Child-Sum Tree-LSTM step of ``examples/tree_lstm.py`` (UDF mailbox
  reduce, weights drawn with numpy) over a batch of its random trees: node
  features within rtol = atol = 1e-5 of max|ref| (f32 on both sides, sums
  in other orders).
- ``farthest_point_sampler`` (batched and not, a start index, ties) and
  ``neighbor_matching`` (weighted and not, relabelled and not): indices
  exactly equal (the port keeps int64 where the reference's are int32).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dgl_tpu
from dgl_tpu import function as jfn
from dgl_tpu import propagate as jprop
from dgl_tpu import traversal as jtrav
from dgl_tpu.base import DGLError as JDGLError
from dgl_tpu.geometry import farthest_point_sampler as j_fps
from dgl_tpu.geometry import neighbor_matching as j_match
import dgl_tpu_torch as dt
from dgl_tpu_torch import function as tfn
from dgl_tpu_torch import propagate as tprop
from dgl_tpu_torch import traversal as ttrav
from dgl_tpu_torch.base import DGLError
from dgl_tpu_torch.geometry import farthest_point_sampler, neighbor_matching

TOL = 1e-5


def _pair(src, dst, n, num_edges=None):
    kw = {} if num_edges is None else {"num_edges": num_edges}
    return (dgl_tpu.graph((src, dst), num_nodes=n, **kw),
            dt.graph((src, dst), num_nodes=n, device="cpu", **kw))


def _cyclic(padded=False):
    rng = np.random.default_rng(0)
    n, e = 30, 70
    src, dst = rng.integers(0, n - 3, e), rng.integers(0, n - 3, e)
    src = np.r_[src, src[:3], 4, 9]
    dst = np.r_[dst, dst[:3], 4, 9]  # multi-edges, self-loops; 3 isolated
    if not padded:
        return _pair(src, dst, n)
    E = src.shape[0]
    return _pair(np.r_[src, [n] * 4], np.r_[dst, [n] * 4], n, E)


def _dag():
    rng = np.random.default_rng(1)
    n = 25
    u, v = rng.integers(0, n, 60), rng.integers(0, n, 60)
    keep = u < v
    return _pair(u[keep], v[keep], n)


def random_trees(num_trees, max_nodes, rng):
    """``examples/tree_lstm.py``'s random rooted trees, edges child ->
    parent, as (src, dst, n)."""
    trees = []
    for _ in range(num_trees):
        n = int(rng.integers(3, max_nodes))
        parents = [int(rng.integers(0, i)) for i in range(1, n)]
        trees.append((np.arange(1, n), np.array(parents), n))
    return trees


def _forest(num_trees=6, max_nodes=12, seed=0):
    trees = random_trees(num_trees, max_nodes, np.random.default_rng(seed))
    jf = dgl_tpu.batch([dgl_tpu.graph((s, d), num_nodes=n)
                        for s, d, n in trees])
    tf = dt.batch([dt.graph((s, d), num_nodes=n, device="cpu")
                   for s, d, n in trees])
    return jf, tf


GRAPHS = {"cyclic": _cyclic, "padded": lambda: _cyclic(True), "dag": _dag,
          "forest": _forest}
SOURCES = {"one": 0, "several": np.array([3, 0, 7]), "isolated": 28}


def _same_frontiers(got, ref):
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        assert isinstance(a, np.ndarray) and a.dtype == np.int64
        np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("source", sorted(SOURCES))
@pytest.mark.parametrize("graph", sorted(GRAPHS))
@pytest.mark.parametrize("name", ["bfs_nodes_generator",
                                  "bfs_edges_generator",
                                  "dfs_edges_generator"])
def test_search_generators_match(name, graph, source, reverse):
    jg, tg = GRAPHS[graph]()
    src = SOURCES[source]
    if np.max(src) >= tg.num_nodes():
        src = tg.num_nodes() - 1
    _same_frontiers(getattr(ttrav, name)(tg, src, reverse),
                    getattr(jtrav, name)(jg, src, reverse))


@pytest.mark.parametrize("flags", [(False, False), (True, False),
                                   (False, True), (True, True)])
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_dfs_labeled_edges_match(graph, flags):
    jg, tg = GRAPHS[graph]()
    for reverse in (False, True):
        got = ttrav.dfs_labeled_edges_generator(tg, [0, 5], reverse, *flags)
        ref = jtrav.dfs_labeled_edges_generator(jg, [0, 5], reverse, *flags)
        for a, b in zip(got, ref):
            _same_frontiers(a, b)


@pytest.mark.parametrize("graph", ["dag", "forest"])
def test_topological_generator_matches(graph):
    jg, tg = GRAPHS[graph]()
    for reverse in (False, True):
        _same_frontiers(ttrav.topological_nodes_generator(tg, reverse),
                        jtrav.topological_nodes_generator(jg, reverse))


def test_topological_generator_raises_on_a_cycle():
    jg, tg = _cyclic()
    with pytest.raises(JDGLError):
        jtrav.topological_nodes_generator(jg)
    with pytest.raises(DGLError):
        ttrav.topological_nodes_generator(tg)


# ---------------------------------------------------------------------------
# ordered propagation
# ---------------------------------------------------------------------------


def _feats(jg, tg, seed=2, width=4):
    x = np.random.default_rng(seed).normal(
        size=(tg.num_nodes(), width)).astype(np.float32)
    jg.ndata["h"], tg.ndata["h"] = jnp.asarray(x), torch.from_numpy(x)
    e = np.random.default_rng(seed + 1).normal(
        size=(tg._relation().num_edges_padded, 1)).astype(np.float32)
    jg.edata["w"], tg.edata["w"] = jnp.asarray(e), torch.from_numpy(e)


def _close(got, ref, what="h"):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=TOL,
                               atol=TOL * max(np.abs(ref).max(), 1e-30),
                               err_msg=what)


def _funcs(fn_mod, udf, np_mod):
    """(message, reduce, apply) builtin or UDF, the apply a tanh."""
    if udf:
        def msg(edges):
            return {"m": edges.src["h"] * edges.data["w"]}

        def red(nodes):
            mask = nodes.mailbox_mask[..., None]
            return {"h": (nodes.mailbox["m"] * mask).sum(1) + 0.5}
    else:
        msg, red = fn_mod.u_mul_e("h", "w", "m"), fn_mod.sum("m", "h")

    def apply(nodes):
        return {"h": np_mod.tanh(nodes.data["h"])}

    return msg, red, apply


CALLS = {
    "prop_nodes_bfs": lambda p, g, f: p.prop_nodes_bfs(g, [0, 2], *f),
    "prop_nodes_bfs_reverse": lambda p, g, f: p.prop_nodes_bfs(
        g, 1, *f, reverse=True),
    "prop_edges_dfs": lambda p, g, f: p.prop_edges_dfs(g, 0, *f),
    "prop_edges_dfs_no_apply": lambda p, g, f: p.prop_edges_dfs(
        g, [4, 0], f[0], f[1], reverse=True),
    "prop_nodes_topo": lambda p, g, f: p.prop_nodes_topo(g, *f),
    "prop_nodes_topo_reverse": lambda p, g, f: p.prop_nodes_topo(
        g, *f, reverse=True),
    "prop_nodes_given": lambda p, g, f: p.prop_nodes(
        g, [np.array([3, 1]), np.array([0])], *f),
    "prop_edges_given": lambda p, g, f: p.prop_edges(
        g, [np.array([0, 4]), np.array([2])], *f),
    "Graph.prop_nodes": lambda p, g, f: g.prop_nodes(
        [np.array([2, 5, 6])], *f),
    "Graph.prop_edges": lambda p, g, f: g.prop_edges(
        [np.array([1, 3]), np.array([0])], *f),
}


@pytest.mark.parametrize("udf", [False, True], ids=["builtin", "udf"])
@pytest.mark.parametrize("graph", ["dag", "forest", "padded"])
@pytest.mark.parametrize("call", sorted(CALLS))
def test_propagation_matches(call, graph, udf):
    if "topo" in call and graph == "padded":
        graph = "dag"  # a cycle: both raise (tested above)
    jg, tg = GRAPHS[graph]()
    _feats(jg, tg)
    CALLS[call](jprop, jg, _funcs(jfn, udf, jnp))
    CALLS[call](tprop, tg, _funcs(tfn, udf, torch))
    _close(tg.ndata["h"], jg.ndata["h"])


def _tree_lstm_weights(x_size, h_size, seed=4):
    rng = np.random.default_rng(seed)
    return {k: (rng.normal(size=s) * 0.3).astype(np.float32) for k, s in
            {"W_iou": (x_size, 3 * h_size), "U_iou": (h_size, 3 * h_size),
             "b_iou": (3 * h_size,), "U_f": (h_size, h_size),
             "b_f": (h_size,)}.items()}


def tree_lstm(prop, g, x, w, np_mod, sigmoid):
    """The Child-Sum Tree-LSTM of ``examples/tree_lstm.py`` through
    ``prop_nodes_topo``: leaves first, a UDF mailbox reduce."""
    H = w["U_f"].shape[0]
    g.ndata["iou_x"] = x @ w["W_iou"]
    g.ndata["h"] = x[:, :1] * 0 + np_mod.zeros((g.num_nodes(), H))
    g.ndata["c"] = g.ndata["h"]
    g.ndata["h_sum"] = g.ndata["h"]
    g.ndata["c_f"] = g.ndata["h"]

    def msg(edges):
        return {"h": edges.src["h"], "c": edges.src["c"]}

    def red(nodes):
        mask = nodes.mailbox_mask[..., None]
        h_child = nodes.mailbox["h"]
        f = sigmoid(h_child @ w["U_f"] + w["b_f"])
        return {"h_sum": (h_child * mask).sum(1),
                "c_f": (f * nodes.mailbox["c"] * mask).sum(1)}

    def apply(nodes):
        iou = nodes.data["iou_x"] + nodes.data["h_sum"] @ w["U_iou"] \
            + w["b_iou"]
        i, o, u = iou[:, :H], iou[:, H: 2 * H], iou[:, 2 * H:]
        c = sigmoid(i) * np_mod.tanh(u) + nodes.data["c_f"]
        return {"h": sigmoid(o) * np_mod.tanh(c), "c": c}

    prop.prop_nodes_topo(g, msg, red, apply)
    return g.ndata["h"]


def test_tree_lstm_over_prop_nodes_topo():
    jg, tg = _forest(num_trees=16, max_nodes=12, seed=0)
    x = np.random.default_rng(6).normal(size=(tg.num_nodes(), 16)).astype(
        np.float32)
    w = _tree_lstm_weights(16, 8)
    ref = tree_lstm(jprop, jg, jnp.asarray(x),
                    {k: jnp.asarray(v) for k, v in w.items()}, jnp,
                    jax.nn.sigmoid)
    got = tree_lstm(tprop, tg, torch.from_numpy(x),
                    {k: torch.from_numpy(v) for k, v in w.items()}, torch,
                    torch.sigmoid)
    _close(got, ref)
    assert float(np.abs(np.asarray(ref)).min()) > 0  # every node reached


# ---------------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("start", [None, 3])
@pytest.mark.parametrize("shape,npoints", [((2, 64, 3), 16), ((50, 2), 50),
                                           ((3, 40, 5), 1)])
def test_farthest_point_sampler_matches(shape, npoints, start):
    pos = np.random.default_rng(7).normal(size=shape).astype(np.float32)
    got = farthest_point_sampler(torch.from_numpy(pos), npoints, start)
    ref = j_fps(pos, npoints, start)
    assert got.dtype == torch.int64 and got.shape == ref.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_farthest_point_sampler_ties_take_the_first_index():
    """A grid: many points tie for the farthest; both pick the lowest."""
    g = np.stack(np.meshgrid(np.arange(5), np.arange(5)), -1).reshape(
        -1, 2).astype(np.float32)
    pos = np.stack([g, g[::-1].copy()])
    got = farthest_point_sampler(pos, 12, device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(j_fps(pos, 12)))


@pytest.mark.parametrize("relabel", [True, False])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("graph", ["cyclic", "padded", "forest"])
def test_neighbor_matching_matches(graph, weighted, relabel):
    jg, tg = GRAPHS[graph]()
    w = None
    if weighted:
        w = np.random.default_rng(8).random(tg.num_edges()).astype(
            np.float32)
    got = neighbor_matching(tg, None if w is None else torch.from_numpy(w),
                            relabel)
    ref = j_match(jg, w, relabel)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
