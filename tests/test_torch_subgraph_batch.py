"""The port's ``subgraph.py``, ``batch.py`` and ``readout.py`` against
``dgl_tpu``: node, edge, in, out and k-hop subgraphs (relabelled or not,
one and several types, padded graphs), ``batch``/``unbatch`` (a round
trip), ``slice_batch``, ``pad_batch``'s ghost graphs and ``stack_graphs``;
every readout on a batch of graphs of uneven sizes (an empty graph
included), with weights, ``topk_*`` with ties and segments shorter than
``k``, and the gradients of the reductions and softmaxes.

Tolerances: graphs, ids and selections exact; f32 readouts rtol = atol =
1e-5 (the same f32 sums in other orders).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dgl_tpu
import dgl_tpu_torch as dt
from test_torch_graph_utils import (assert_same, hetero_pair, homo_pair,
                                    np_of, same_graph, with_frames)

TOL = dict(rtol=1e-5, atol=1e-5)


def _pairs(kind):
    return {"homo": homo_pair, "padded": lambda: homo_pair(padded=True),
            "hetero": hetero_pair}[kind]()


SUBGRAPHS = {
    "node_subgraph": lambda m, g, seeds: m.node_subgraph(g, seeds),
    "node_subgraph_mask": lambda m, g, seeds: m.node_subgraph(
        g, {nt: np.arange(g.num_nodes(nt)) % 2 == 0 for nt in g.ntypes}
        if len(g.ntypes) > 1 else np.arange(g.num_nodes()) % 2 == 0),
    "node_subgraph_no_ids": lambda m, g, seeds: m.node_subgraph(
        g, seeds, store_ids=False),
    "in_subgraph": lambda m, g, seeds: m.in_subgraph(g, seeds),
    "in_subgraph_relabel": lambda m, g, seeds: m.in_subgraph(
        g, seeds, relabel_nodes=True),
    "out_subgraph": lambda m, g, seeds: m.out_subgraph(g, seeds),
    "out_subgraph_relabel": lambda m, g, seeds: m.out_subgraph(
        g, seeds, relabel_nodes=True, store_ids=False),
    "khop_in_subgraph": lambda m, g, seeds: m.khop_in_subgraph(g, seeds, 2),
    "khop_out_subgraph": lambda m, g, seeds: m.khop_out_subgraph(g, seeds,
                                                                 1),
    "edge_subgraph": lambda m, g, seeds: m.edge_subgraph(
        g, {cet: np.array([5, 0, 3]) for cet in g.canonical_etypes}
        if len(g.canonical_etypes) > 1 else np.array([5, 0, 3, 3])),
    "edge_subgraph_mask": lambda m, g, seeds: m.edge_subgraph(
        g, np.arange(g.num_edges()) % 3 == 1, relabel_nodes=False)
    if len(g.canonical_etypes) == 1 else m.edge_subgraph(
        g, {"buys": np.array([1, 2])}, relabel_nodes=False),
}


def _seeds(g):
    if len(g.ntypes) == 1:
        return np.array([5, 0, 9])
    return {"user": np.array([2, 0]), "item": np.array([6])}


def _same(got, ref):
    if isinstance(ref, dgl_tpu.Graph):
        same_graph(got, ref)
    elif isinstance(ref, (tuple, list)):
        for a, b in zip(got, ref):
            _same(a, b)
    else:
        assert_same(got, ref)


@pytest.mark.parametrize("kind", ["homo", "padded", "hetero"])
@pytest.mark.parametrize("name", sorted(SUBGRAPHS))
def test_subgraph_matches(name, kind):
    jg, tg = _pairs(kind)
    fn = SUBGRAPHS[name]
    _same(fn(dt, tg, _seeds(tg)), fn(dgl_tpu, jg, _seeds(jg)))


# ---------------------------------------------------------------------------
# batch
# ---------------------------------------------------------------------------


def _graph_list(sizes, seed=0, padded_last=False):
    """Homogeneous graphs of (nodes, edges) ``sizes`` with features; the
    last one padded when asked."""
    rng = np.random.default_rng(seed)
    js, ts = [], []
    for i, (n, e) in enumerate(sizes):
        src = rng.integers(0, max(n, 1), e) if n else np.zeros(0, np.int64)
        dst = rng.integers(0, max(n, 1), e) if n else np.zeros(0, np.int64)
        kw = {}
        if padded_last and i == len(sizes) - 1:
            src, dst = np.r_[src, n, n], np.r_[dst, n, n]
            kw = {"num_edges": e}
        jg = dgl_tpu.graph((src, dst), num_nodes=n, **kw)
        tg = dt.graph((src, dst), num_nodes=n, device="cpu", **kw)
        with_frames(jg, tg, seed=seed + i)
        js.append(jg)
        ts.append(tg)
    return js, ts


SIZES = [(5, 9), (1, 0), (8, 20), (0, 0), (3, 4), (6, 11)]


def test_batch_unbatch_round_trip():
    js, ts = _graph_list(SIZES)
    jb, tb = dgl_tpu.batch(js), dt.batch(ts)
    same_graph(tb, jb)
    for tu, ju, tg in zip(dt.unbatch(tb), dgl_tpu.unbatch(jb), ts):
        same_graph(tu, ju)
        for k in ("x",):
            assert torch.equal(tu.ndata[k], tg.ndata[k])
        assert torch.equal(tu.edata["w"], tg.edata["w"])
    # a batch of batches counts its inputs, as the reference does
    same_graph(dt.batch([tb, ts[0]]), dgl_tpu.batch([jb, js[0]]))


def test_batch_padded_and_hetero():
    js, ts = _graph_list(SIZES[:3], seed=3, padded_last=True)
    same_graph(dt.batch(ts), dgl_tpu.batch(js))
    jh, th = hetero_pair()
    jh2, th2 = hetero_pair()
    jb, tb = dgl_tpu.batch([jh, jh2]), dt.batch([th, th2])
    same_graph(tb, jb)
    for tu, ju in zip(dt.unbatch(tb), dgl_tpu.unbatch(jb)):
        same_graph(tu, ju)
    for gid in (0, 1):
        same_graph(dt.slice_batch(tb, gid, store_ids=True),
                   dgl_tpu.slice_batch(jb, gid, store_ids=True))


@pytest.mark.parametrize("gid", range(len(SIZES)))
def test_slice_batch(gid):
    js, ts = _graph_list(SIZES)
    jb, tb = dgl_tpu.batch(js), dt.batch(ts)
    for store in (False, True):
        same_graph(dt.slice_batch(tb, gid, store_ids=store),
                   dgl_tpu.slice_batch(jb, gid, store_ids=store))


def test_pad_batch_ghost_graphs():
    js, ts = _graph_list(SIZES[:3])
    for args in ((6, 40, 50), (4, 15, 29)):
        (tb, tmask), (jb, jmask) = (dt.pad_batch(ts, *args),
                                    dgl_tpu.pad_batch(js, *args))
        same_graph(tb, jb)
        assert_same(tmask, jmask)
        assert tb.num_nodes() == args[1] and tb.num_edges() == args[2]
    for bad in ((3, 40, 50), (6, 16, 50), (6, 40, 10)):
        with pytest.raises(dt.DGLError):
            dt.pad_batch(ts, *bad)


def test_stack_graphs():
    js, ts = [], []
    for seed in (0, 1, 2):
        rng = np.random.default_rng(seed)
        src, dst = rng.integers(0, 6, 15), rng.integers(0, 6, 15)
        jg = dgl_tpu.graph((src, dst), num_nodes=6)
        tg = dt.graph((src, dst), num_nodes=6, device="cpu")
        with_frames(jg, tg, seed=seed)
        js.append(jg)
        ts.append(tg)
    jst, tst = dgl_tpu.stack_graphs(js), dt.stack_graphs(ts)
    same_graph(tst, jst)
    assert tst._relation().src.shape == (3, 15)


# ---------------------------------------------------------------------------
# readout
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def batches():
    js, ts = _graph_list(SIZES, seed=7)
    jb, tb = dgl_tpu.batch(js), dt.batch(ts)
    rng = np.random.default_rng(8)
    # ties: a repeated key within a graph
    x = rng.normal(size=(tb.num_nodes(), 3)).astype(np.float32)
    x[1, 0] = x[3, 0]
    x[14:17, 1] = 0.5
    nw = rng.uniform(0.5, 1.5, (tb.num_nodes(), 1)).astype(np.float32)
    ew = rng.uniform(0.5, 1.5, tb.num_edges()).astype(np.float32)
    for g, conv in ((jb, jnp.asarray), (tb, torch.from_numpy)):
        g.ndata["x"], g.ndata["nw"], g.edata["ew"] = conv(x), conv(nw), \
            conv(ew)
    # a padded graph of one graph: its padded edge rows fall in its segment
    js2, ts2 = _graph_list([(6, 10)], seed=9, padded_last=True)
    ew = rng.uniform(0.5, 1.5, 12).astype(np.float32)
    js2[0].edata["ew"], ts2[0].edata["ew"] = jnp.asarray(ew), \
        torch.from_numpy(ew)
    return (jb, tb), (js2[0], ts2[0])


READOUTS = {
    "sum_nodes": lambda m, g: m.sum_nodes(g, "x"),
    "mean_nodes": lambda m, g: m.mean_nodes(g, "x"),
    "max_nodes": lambda m, g: m.max_nodes(g, "x"),
    "min_nodes": lambda m, g: m.readout_nodes(g, "x", op="min"),
    "sum_nodes_weighted": lambda m, g: m.sum_nodes(g, "x", weight="nw"),
    "sum_edges": lambda m, g: m.sum_edges(g, "w"),
    "mean_edges": lambda m, g: m.mean_edges(g, "w", weight="ew"),
    "max_edges": lambda m, g: m.max_edges(g, "w"),
    "readout_edges_min": lambda m, g: m.readout_edges(g, "w", op="min"),
    "softmax_nodes": lambda m, g: m.softmax_nodes(g, "x"),
    "softmax_edges": lambda m, g: m.softmax_edges(g, "w"),
    "broadcast_nodes": lambda m, g: m.broadcast_nodes(
        g, m.sum_nodes(g, "x")),
    "broadcast_edges": lambda m, g: m.broadcast_edges(
        g, m.max_edges(g, "w")),
    "topk_nodes": lambda m, g: m.topk_nodes(g, "x", 4, sortby=0),
    "topk_nodes_sortby1_asc": lambda m, g: m.topk_nodes(
        g, "x", 2, descending=False, sortby=1),
    "topk_nodes_column": lambda m, g: m.topk_nodes(g, "nw", 3, sortby=0),
    "topk_edges": lambda m, g: m.topk_edges(g, "w", 3, sortby=1),
    "topk_edges_asc": lambda m, g: m.topk_edges(g, "w", 12,
                                                descending=False, sortby=0),
}


@pytest.mark.parametrize("name", sorted(READOUTS))
def test_readout_matches(name, batches):
    (jb, tb), (jp, tp) = batches
    fn = READOUTS[name]
    assert_same(fn(dt, tb), fn(dgl_tpu, jb))
    if "nodes" not in name:  # a padded graph's edge rows
        assert_same(fn(dt, tp), fn(dgl_tpu, jp))


def test_topk_rejects_3d_keys(batches):
    (_, tb), _ = batches
    tb.ndata["cube"] = torch.zeros(tb.num_nodes(), 2, 2)
    with pytest.raises(dt.DGLError):
        dt.topk_nodes(tb, "cube", 2)


@pytest.mark.parametrize("op", ["sum", "mean", "max", "min", "softmax"])
def test_readout_gradients(op, batches):
    (jb, tb), _ = batches
    x = np_of(tb.ndata["x"])
    cot = np.random.default_rng(12).normal(
        size=(tb.batch_size if op != "softmax" else tb.num_nodes(), 3)
    ).astype(np.float32)

    def jfn(v):
        g = jb.local_var()
        g.ndata["x"] = v
        return (dgl_tpu.softmax_nodes(g, "x") if op == "softmax"
                else dgl_tpu.readout_nodes(g, "x", op=op))

    _, pull = jax.vjp(jfn, jnp.asarray(x))
    ref = np.asarray(pull(jnp.asarray(cot))[0])
    t = torch.from_numpy(x).requires_grad_()
    g = tb.local_var()
    g.ndata["x"] = t
    out = (dt.softmax_nodes(g, "x") if op == "softmax"
           else dt.readout_nodes(g, "x", op=op))
    out.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(t.grad.numpy(), ref, **TOL)
