"""The port's host samplers (``dgl_tpu_torch.sampling``) against
``dgl_tpu.sampling``, on the same numpy graphs and seeds.

Both packages pick in ``csrc/host_ops.cpp`` (the reference through
``dgl_tpu/_native``, the port through ``dgl_tpu_torch/_host.py``), whose
draws for a row depend on the call's seed and the row alone, and both draw
their seeds and their host loops' picks from the same numpy generators.
So picks, edge ids, subgraphs, walks and pairs are held exactly; float
frames and LABOR's importances at rtol = atol = 1e-6 (the same float64
arithmetic). The reference falls back to numpy draws when its native
library fails to load (an unlocked build that xdist workers can race):
``reference_native`` loads it under a lock of its own first, and fails the
test when it still will not load.
"""
import fcntl
import os
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dgl_tpu
from dgl_tpu import _native
from dgl_tpu import sampling as jsampling
from dgl_tpu import transforms as jtransforms
import dgl_tpu_torch as dt
from dgl_tpu_torch import sampling as tsampling
from dgl_tpu_torch.base import EID, NID

from test_torch_graph_utils import (assert_same, both_raise, hetero_pair,
                                    np_of, same_graph)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def reference_native():
    """Load the reference's native library in this process, retrying its
    build under a file lock after a lost race; fail if it will not load
    (its numpy fallback draws other picks)."""
    if _native._LIB is not None:
        return _native._LIB
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with open(os.path.join(ROOT, "build", "reference_native.lock"),
              "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            for attempt in range(6):
                _native._TRIED = False
                if _native.get_lib() is not None:
                    break
                time.sleep(2.0)  # another process may be mid-build
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    assert _native._LIB is not None, "dgl_tpu's native library did not load"
    return _native._LIB


@pytest.fixture(autouse=True, scope="module")
def _reference_native():
    reference_native()


N, E = 300, 3000


def zipf_arrays(n=N, e=E, seed=0, sinks=5):
    """zipf sources, uniform destinations; the last ``sinks`` nodes have
    no in-edge; parallel edges included."""
    rng = np.random.default_rng(seed)
    w = 1.0 / np.arange(1, n + 1)
    return rng.choice(n, e, p=w / w.sum()), rng.integers(0, n - sinks, e)


def homo_graphs(n=N, e=E, seed=0):
    """The zipf graph on both sides, with edge weights ``p`` (a fifth of
    them 0) and ``w``, node ``timestamp``s and edge ``ets``."""
    src, dst = zipf_arrays(n, e, seed)
    jg = dgl_tpu.graph((src, dst), num_nodes=n)
    tg = dt.graph((src, dst), num_nodes=n, device="cpu")
    rng = np.random.default_rng(seed + 1)
    p = rng.random(e).astype(np.float32)
    p[rng.random(e) < 0.2] = 0.0
    edata = {"p": p, "w": rng.random(e).astype(np.float32),
             "ets": rng.random(e).astype(np.float32)}
    ndata = {"timestamp": rng.random(n).astype(np.float32),
             "h": rng.normal(size=(n, 3)).astype(np.float32)}
    for k, v in edata.items():
        jg.edata[k] = jnp.asarray(v)
        tg.edata[k] = torch.from_numpy(v)
    for k, v in ndata.items():
        jg.ndata[k] = jnp.asarray(v)
        tg.ndata[k] = torch.from_numpy(v)
    return jg, tg


@pytest.fixture(scope="module")
def graphs():
    return homo_graphs()


SEEDS = np.array([0, 1, 2, 3, 17, 150, 297, 299])


# ---------------------------------------------------------------------------
# sample_neighbors and its relatives
# ---------------------------------------------------------------------------

NEIGHBOR_CASES = {
    "in": dict(fanout=5),
    "out": dict(fanout=4, edge_dir="out"),
    "all": dict(fanout=-1),
    "replace": dict(fanout=30, replace=True),
    "prob": dict(fanout=5, prob="p"),
    "prob_replace": dict(fanout=6, prob="p", replace=True),
    "prob_all": dict(fanout=-1, prob="p"),
    "exclude": dict(fanout=8, exclude_edges=np.arange(0, E, 3)),
    "no_frames": dict(fanout=5, copy_ndata=False, copy_edata=False),
    "missing_prob": dict(fanout=5, prob="nope"),
}


@pytest.mark.parametrize("case", sorted(NEIGHBOR_CASES))
def test_sample_neighbors(graphs, case):
    jg, tg = graphs
    kw = NEIGHBOR_CASES[case]
    ref = jsampling.sample_neighbors(jg, SEEDS, seed=3, **kw)
    got = tsampling.sample_neighbors(tg, torch.from_numpy(SEEDS), seed=3,
                                     **kw)
    same_graph(got, ref, case)
    assert got.edata[EID].dtype == torch.int64


def test_sample_neighbors_method_and_hetero():
    jg, tg = hetero_pair()
    nodes = {"user": [0, 3, 8], "item": [1, 2, 6]}
    # the reference reads a canonical key of every edge type first
    fanout = {("user", "buys", "item"): 2, ("item", "bought_by", "user"): 1,
              ("item", "has", "tag"): -1}
    ref = jsampling.sample_neighbors(jg, nodes, fanout, seed=5)
    same_graph(tsampling.sample_neighbors(tg, nodes, fanout, seed=5), ref)
    same_graph(tg.sample_neighbors(nodes, fanout, seed=5), ref, "method")
    both_raise(lambda: jsampling.sample_neighbors(jg, [0], 2),
               lambda: tsampling.sample_neighbors(tg, [0], 2))


@pytest.mark.parametrize("kw", [dict(), dict(replace=True), dict(prob="p"),
                                dict(prob="p", replace=True),
                                dict(edge_dir="out")])
def test_sample_neighbors_fixed(graphs, kw):
    jg, tg = graphs
    ref = jsampling.sample_neighbors_fixed(jg, SEEDS, 7, seed=4, **kw)
    got = tsampling.sample_neighbors_fixed(tg, SEEDS, 7, seed=4, **kw)
    assert [a.dtype for a in got] == [torch.int64, torch.int64, torch.bool]
    assert_same(got, ref)


def _fixed_shape_picks(sampling_mod, g):
    from dgl_tpu.dataloading import FixedShapeNeighborSampler as JSampler
    from dgl_tpu_torch.dataloading import FixedShapeNeighborSampler

    if sampling_mod is jsampling:
        sampler = JSampler([6], 8, prob="p", seed=3)
    else:
        sampler = FixedShapeNeighborSampler([6], 8, prob="p", seed=3,
                                            device="cpu")
    block = sampler.sample_blocks(g, SEEDS)[2][0]
    return np_of(block.edata[EID])[np_of(block.edata["_mask"])]


def _masked(out):
    return np_of(out[1])[np_of(out[2])]


WEIGHTED_PICKS = {
    "sample_neighbors": lambda s, g: np_of(s.sample_neighbors(
        g, SEEDS, 6, prob="p", seed=3).edata[EID]),
    "sample_neighbors_fixed": lambda s, g: _masked(s.sample_neighbors_fixed(
        g, SEEDS, 6, prob="p", seed=3)),
    "sample_labors": lambda s, g: np_of(s.sample_labors(
        g, SEEDS, 6, prob="p", random_seed=3)[0].edata[EID]),
    "fixed_shape_sampler": _fixed_shape_picks,
}


@pytest.mark.parametrize("case", sorted(WEIGHTED_PICKS))
def test_weights_written_in_place_are_read(case):
    """Weights set to 0 in place after a first call (the port keeps a host
    copy of them) are no longer picked, and the picks are the reference's
    over the new weights."""
    pick = WEIGHTED_PICKS[case]
    jg, tg = homo_graphs()
    off = np.unique(pick(tsampling, tg))[::2]
    assert off.size
    tg.edata["p"][torch.from_numpy(off)] = 0.0
    jg.edata["p"] = jnp.asarray(np_of(tg.edata["p"]))
    got = pick(tsampling, tg)
    assert got.size and not np.isin(got, off).any()
    np.testing.assert_array_equal(got, pick(jsampling, jg))


@pytest.mark.parametrize("kw", [dict(), dict(replace=True),
                                dict(edge_timestamp="ets"),
                                dict(seed_timestamps=np.full(8, 0.7))])
def test_temporal_sample_neighbors(graphs, kw):
    jg, tg = graphs
    ref = jsampling.temporal_sample_neighbors(jg, SEEDS, 3, seed=6, **kw)
    got = tsampling.temporal_sample_neighbors(tg, SEEDS, 3, seed=6, **kw)
    assert_same(got, ref)


@pytest.mark.parametrize("kw", [dict(k=3), dict(k=3, ascending=True),
                                dict(k=2, edge_dir="out"), dict(k=0),
                                dict(k=4, nodes=SEEDS)])
def test_select_topk(graphs, kw):
    jg, tg = graphs
    same_graph(tsampling.select_topk(tg, weight="w", **kw),
               jsampling.select_topk(jg, weight="w", **kw))


@pytest.mark.parametrize("edge_dir", ["in", "out"])
def test_sample_neighbors_biased(graphs, edge_dir):
    jg, tg = graphs
    tags = np.random.default_rng(7).integers(0, 3, N)
    sort = "sort_csc_by_tag" if edge_dir == "in" else "sort_csr_by_tag"
    jgs = getattr(jtransforms, sort)(jg, tags)
    tgs = getattr(dt, sort)(tg, tags)
    for bias in ([0.0, 1.0, 2.0], [1.0, 1.0, 1.0]):
        ref = jsampling.sample_neighbors_biased(jgs, SEEDS, 4, bias=bias,
                                                edge_dir=edge_dir, seed=8)
        got = tsampling.sample_neighbors_biased(tgs, SEEDS, 4, bias=bias,
                                                edge_dir=edge_dir, seed=8)
        same_graph(got, ref, str(bias))
    both_raise(
        lambda: jsampling.sample_neighbors_biased(jg, [0], 2, [1.0, 1.0]),
        lambda: tsampling.sample_neighbors_biased(tg, [0], 2, [1.0, 1.0]))


ETYPE_OFFSET = [0, 1000, 2200, E]
ETYPE_CASES = {
    "native": dict(fanout=np.array([1, 2, 3])),
    "replace": dict(fanout=np.array([2, 0, 3]), replace=True),
    "keep_all": dict(fanout=np.array([-1, 2, -1])),
    "prob": dict(fanout=np.array([1, 2, 2]),
                 prob=[np.ones(1000), None,
                       np.linspace(0, 1, E - 2200)]),
    "exclude": dict(fanout=np.array([2, 2, 2]),
                    exclude_edges=np.arange(0, E, 4)),
}


@pytest.mark.parametrize("case", sorted(ETYPE_CASES))
def test_sample_etype_neighbors(graphs, case):
    jg, tg = graphs
    kw = ETYPE_CASES[case]
    same_graph(
        tsampling.sample_etype_neighbors(tg, SEEDS, ETYPE_OFFSET, seed=9,
                                         **kw),
        jsampling.sample_etype_neighbors(jg, SEEDS, ETYPE_OFFSET, seed=9,
                                         **kw), case)


def test_sample_neighbors_fused(graphs):
    jg, tg = graphs
    jmap, tmap = {}, {}
    ref = jsampling.sample_neighbors_fused(jg, [7, 3, 150], 4, seed=1,
                                           mapping=jmap)
    got = tsampling.sample_neighbors_fused(tg, [7, 3, 150], 4, seed=1,
                                           mapping=tmap)
    same_graph(got, ref)
    assert_same(tmap, jmap)
    assert got.ndata[NID].dtype == torch.int64
    same_graph(tsampling.in_subgraph_sample(tg, SEEDS),
               jsampling.in_subgraph_sample(jg, SEEDS))


def test_eid_excluder(graphs):
    jg, tg = graphs
    jf = jsampling.sample_neighbors(jg, SEEDS, 5, seed=0)
    tf = tsampling.sample_neighbors(tg, SEEDS, 5, seed=0)
    banned = np.asarray(jf.edata[EID])[::3]
    same_graph(tsampling.EidExcluder(torch.from_numpy(banned))(tf),
               jsampling.EidExcluder(banned)(jf))


# ---------------------------------------------------------------------------
# LABOR
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [dict(), dict(importance_sampling=1),
                                dict(importance_sampling=2),
                                dict(importance_sampling=-1),
                                dict(prob="p", importance_sampling=1),
                                dict(prob="p"), dict(fanout=-1)])
def test_sample_labors(graphs, kw):
    jg, tg = graphs
    kw = dict(kw)
    fanout = kw.pop("fanout", 5)
    seeds = np.arange(0, N, 3)
    jsub, jimp = jsampling.sample_labors(jg, seeds, fanout, random_seed=2,
                                         **kw)
    tsub, timp = tsampling.sample_labors(tg, seeds, fanout, random_seed=2,
                                         **kw)
    same_graph(tsub, jsub)
    assert [t.dtype for t in timp] == [torch.float64]
    assert_same(timp, [np.asarray(a) for a in jimp])


def test_sample_labors_hetero():
    jg, tg = hetero_pair()
    nodes = {"user": [0, 3, 8], "item": [1, 2, 6], "tag": [0, 1]}
    jsub, jimp = jsampling.sample_labors(jg, nodes, 2, random_seed=4,
                                         importance_sampling=1)
    tsub, timp = tsampling.sample_labors(tg, nodes, 2, random_seed=4,
                                         importance_sampling=1)
    same_graph(tsub, jsub)
    assert_same(timp, [np.asarray(a) for a in jimp])


# ---------------------------------------------------------------------------
# random walks, negative pairs, PinSAGE
# ---------------------------------------------------------------------------

WALK_CASES = {
    "uniform": dict(length=6),
    "restart": dict(length=6, restart_prob=0.3),
    "prob": dict(length=5, prob="p"),
    "eids": dict(length=4, return_eids=True),
}


@pytest.mark.parametrize("case", sorted(WALK_CASES))
def test_random_walk(graphs, case):
    jg, tg = graphs
    kw = WALK_CASES[case]
    seeds = np.concatenate([SEEDS, [298, 299]])  # sinks end at once
    ref = jsampling.random_walk(jg, seeds, seed=11, **kw)
    got = tsampling.random_walk(tg, seeds, seed=11, **kw)
    assert all(t.dtype == torch.int64 for t in got)
    assert_same(got, ref)


def _metapath_pair():
    rng = np.random.default_rng(12)
    iu = (rng.integers(0, 20, 100), rng.integers(0, 10, 100))
    data = {("item", "liked-by", "user"): iu,
            ("user", "likes", "item"): (iu[1], iu[0])}
    counts = {"item": 20, "user": 10}
    return (dgl_tpu.heterograph(data, counts),
            dt.heterograph(data, counts, device="cpu"))


def test_random_walk_metapath_and_node2vec(graphs):
    jh, th = _metapath_pair()
    path = ["liked-by", "likes", "liked-by"]
    for kw in (dict(), dict(return_eids=True), dict(restart_prob=0.2)):
        assert_same(
            tsampling.random_walk(th, [0, 4, 19], metapath=path, seed=2,
                                  **kw),
            jsampling.random_walk(jh, [0, 4, 19], metapath=path, seed=2,
                                  **kw))
    jg, tg = graphs
    for p, q in ((1.0, 1.0), (0.5, 2.0), (4.0, 0.25)):
        assert_same(
            tsampling.node2vec_random_walk(tg, SEEDS, p, q, 6, seed=3),
            jsampling.node2vec_random_walk(jg, SEEDS, p, q, 6, seed=3))
    both_raise(lambda: jsampling.random_walk(jh, [0], length=3),
               lambda: tsampling.random_walk(th, [0], length=3))
    both_raise(lambda: jsampling.random_walk(jh, [0], metapath=["likes"] * 2),
               lambda: tsampling.random_walk(th, [0],
                                             metapath=["likes"] * 2))


def test_pack_traces(graphs):
    jg, tg = graphs
    traces, types = jsampling.random_walk(jg, SEEDS, length=5,
                                          restart_prob=0.4, seed=1)
    ref = jsampling.pack_traces(traces, types)
    got = tsampling.pack_traces(torch.from_numpy(np.asarray(traces)),
                                torch.from_numpy(np.asarray(types)))
    assert_same(got, ref)
    assert_same(tsampling.pack_traces(np.zeros((0, 3), np.int64),
                                      np.zeros(3, np.int64)),
                jsampling.pack_traces(np.zeros((0, 3), np.int64),
                                      np.zeros(3, np.int64)))


@pytest.mark.parametrize("kw", [dict(), dict(replace=True),
                                dict(exclude_self_loops=False),
                                dict(num_samples=5000)])
def test_global_uniform_negative_sampling(graphs, kw):
    jg, tg = graphs
    kw = dict(kw)
    num = kw.pop("num_samples", 400)
    ref = jsampling.global_uniform_negative_sampling(jg, num, seed=13, **kw)
    got = tsampling.global_uniform_negative_sampling(tg, num, seed=13, **kw)
    assert_same(got, ref)
    assert_same(tg.global_uniform_negative_sampling(num, seed=13, **kw), ref)


def test_negative_sampling_dense_graph_returns_fewer():
    """A nearly complete graph: the rounds run out before the count."""
    src, dst = np.nonzero(~np.eye(12, dtype=bool))
    keep = np.arange(src.shape[0]) % 9 != 0
    jg = dgl_tpu.graph((src[keep], dst[keep]), num_nodes=12)
    tg = dt.graph((src[keep], dst[keep]), num_nodes=12, device="cpu")
    ref = jsampling.global_uniform_negative_sampling(jg, 100, seed=1)
    got = tsampling.global_uniform_negative_sampling(tg, 100, seed=1)
    assert_same(got, ref)
    assert got[0].shape[0] < 100


def test_pinsage_samplers():
    jh, th = _metapath_pair()
    ref = jsampling.PinSAGESampler(jh, "item", "user", 2, 0.2, 10, 3,
                                   seed=0)([0, 1, 7])
    got = tsampling.PinSAGESampler(th, "item", "user", 2, 0.2, 10, 3,
                                   seed=0)([0, 1, 7])
    same_graph(got, ref)
    assert got.device.type == "cpu"
    jg, tg = homo_graphs(60, 500, seed=4)
    ref = jsampling.RandomWalkNeighborSampler(jg, 3, 0.3, 8, 4, seed=1)(
        [0, 5, 9])
    same_graph(tsampling.RandomWalkNeighborSampler(tg, 3, 0.3, 8, 4,
                                                   seed=1)([0, 5, 9]), ref)
    both_raise(
        lambda: jsampling.PinSAGESampler(jh, "item", "item", 1, 0.1, 1, 1),
        lambda: tsampling.PinSAGESampler(th, "item", "item", 1, 0.1, 1, 1))


def test_native_bindings_match_the_reference():
    """Each binding of ``_host.py`` against ``dgl_tpu._native``'s, the
    seed ranges checked."""
    from dgl_tpu_torch import _host

    rng = np.random.default_rng(14)
    src, dst = zipf_arrays(80, 600, seed=14)
    order = np.argsort(dst, kind="stable")
    indptr = np.concatenate([[0], np.cumsum(np.bincount(dst, minlength=80))])
    indices, eids = src[order], order
    seeds = rng.permutation(80)[:20]
    prob = rng.random(600)
    calls = {
        "sample_neighbors_fixed": (indptr, indices, eids, seeds, 4, False,
                                   77),
        "sample_neighbors_prob": (indptr, indices, eids, prob, seeds, 4,
                                  True, 78),
        "select_topk_rows": (indptr, indices, eids, prob, seeds, 3, True),
        "unique_and_compact": (rng.integers(0, 50, 200),),
        "random_walk_uniform": (indptr, indices, seeds, 5, 79),
        "sample_neighbors_etype": (indptr, indices, eids,
                                   rng.integers(0, 3, 600),
                                   np.array([1, 0, 2]),
                                   np.concatenate([seeds, [-1]]), False, 80),
    }
    for name, args in calls.items():
        assert_same(getattr(_host, name)(*args), getattr(_native, name)(*args),
                    name)
    with pytest.raises(ValueError, match="seed ids"):
        _host.sample_neighbors_fixed(indptr, indices, eids, [80], 2, False, 0)
