"""The port's remaining modules against ``dgl_tpu``'s, on the same numpy
inputs:

- shared memory both ways: a heterograph with node and edge frames
  published by one package attaches in the other (and in a process that
  ``multiprocessing_mod.Process`` spawns), structure and frames equal;
- the homophily measures within 1e-12 relative, ``get_long_edges`` exact;
- ``merge``, ``Filter`` and ``relabel`` exact, ``mpops`` within 1e-6;
- ``random.seed`` then ``choice`` / ``next_seed``, exact;
- ``build_tree_levels`` exact and ``tree_segment_sum`` within 1e-5 of
  max|ref| on random segment counts with empty segments;
- ``SparseAdagrad`` / ``SparseAdam`` within 1e-5, untouched rows exact;
- ``precompute_sage_neigh`` and ``SAGEConv(precomputed_neigh=...)``
  within 1e-5, flax parameters carried across;
- ``StageTimer``, ``timed_stage``, ``profile_trace``,
  ``run_with_watchdog``, ``check_devices`` (False where no card answers),
  ``config``, the logger, ``DGLWarning`` and the last public names.
"""
import dataclasses
import glob
import json
import os
import time
import uuid
import warnings
from multiprocessing import shared_memory

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dgl_tpu
import dgl_tpu.convert as jconvert
from dgl_tpu.ops import chunk_tree as j_tree
import dgl_tpu_torch as dt
from dgl_tpu_torch import multiprocessing_mod as tmp_mod
from dgl_tpu_torch import profiler as tprof
from dgl_tpu_torch.ops import chunk_tree as t_tree

from test_torch_data import same_graph
from test_torch_sampling import reference_native

CPU = {"device": "cpu"}


def np_of(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


# ---------------------------------------------------------------------------
# shared memory
# ---------------------------------------------------------------------------


def _hetero_data(seed=0):
    rng = np.random.default_rng(seed)
    data = {("u", "r", "v"): (rng.integers(0, 10, 30), rng.integers(0, 8, 30)),
            ("v", "s", "u"): (rng.integers(0, 8, 20), rng.integers(0, 10, 20))}
    frames = {"x": np.arange(10.0, dtype=np.float32),
              "h": rng.normal(size=(8, 3)).astype(np.float32),
              "w": np.arange(30.0, dtype=np.float32),
              "k": rng.integers(0, 5, 20).astype(np.int32)}
    return data, frames


def _fill(g, frames, to):
    g.nodes["u"].data["x"] = to(frames["x"])
    g.nodes["v"].data["h"] = to(frames["h"])
    g.edges_view[("u", "r", "v")].data["w"] = to(frames["w"])
    g.edges_view[("v", "s", "u")].data["k"] = to(frames["k"])
    return g


def _port_hetero(seed=0):
    data, frames = _hetero_data(seed)
    return _fill(dt.heterograph(data, **CPU), frames, torch.from_numpy)


def _reference_hetero(seed=0):
    data, frames = _hetero_data(seed)
    return _fill(jconvert.heterograph(data), frames, jnp.asarray)


@pytest.fixture
def shm_name():
    name = f"dgl_torch_{os.getpid()}_{uuid.uuid4().hex[:8]}"
    yield name
    try:
        shm = shared_memory.SharedMemory(name)
    except FileNotFoundError:
        return
    shm.close()
    shm.unlink()


def test_port_publishes_and_attaches(shm_name):
    g = _port_hetero()
    assert g.shared_memory(shm_name) is g
    back = dt.hetero_from_shared_memory(shm_name, **CPU)
    same_graph(back, _reference_hetero(), "port -> port")
    for cet in g.canonical_etypes:
        for a, b in zip(g.edges(etype=cet), back.edges(etype=cet)):
            assert torch.equal(a, b)
    assert back.nodes["v"].data["h"].dtype == torch.float32
    # publishing the name again replaces the block
    _port_hetero(seed=1).shared_memory(shm_name)
    again = dt.hetero_from_shared_memory(shm_name, **CPU)
    same_graph(again, _reference_hetero(seed=1), "republished")


def test_reference_publishes_and_port_attaches(shm_name):
    ref = _reference_hetero()
    ref.shared_memory(shm_name)
    back = dt.hetero_from_shared_memory(shm_name, **CPU)
    same_graph(back, ref, "reference -> port")


def test_port_publishes_and_reference_attaches(shm_name):
    g = _port_hetero()
    g.shared_memory(shm_name)
    back = jconvert.hetero_from_shared_memory(shm_name)
    same_graph(g, back, "port -> reference")


def test_homogeneous_graph_in_shared_memory(shm_name):
    g = dt.rand_graph(50, 200, seed=3, **CPU)
    g.ndata["feat"] = torch.randn(50, 4)
    g.shared_memory(shm_name)
    back = jconvert.hetero_from_shared_memory(shm_name)
    same_graph(g, back, "homogeneous port -> reference")
    same_graph(dt.hetero_from_shared_memory(shm_name, **CPU), back,
               "homogeneous port -> port")


def test_spawned_process_attaches(shm_name):
    import torch_shm_worker

    g = _port_hetero()
    g.shared_memory(shm_name)
    q = tmp_mod.Queue()
    p = tmp_mod.Process(target=torch_shm_worker.attach_and_report,
                        args=(shm_name, q))
    p.start()
    try:
        got = q.get(timeout=90)
    finally:
        p.join(timeout=30)
    assert p.exitcode == 0
    assert got["num_nodes"] == {"u": 10, "v": 8}
    for cet in g.canonical_etypes:
        assert np.array_equal(got[f"edges {cet}"], np.stack(
            [a.numpy() for a in g.edges(etype=cet)]))
    _data, frames = _hetero_data()
    assert np.array_equal(got["ndata u x"], frames["x"])
    assert np.array_equal(got["ndata v h"], frames["h"])
    assert np.array_equal(got["edata ('u', 'r', 'v') w"], frames["w"])
    assert np.array_equal(got["edata ('v', 's', 'u') k"], frames["k"])


def test_multiprocessing_helpers():
    assert tmp_mod.get_context().get_start_method() == "spawn"
    t, handle = tmp_mod.call_once_and_share(
        lambda: np.arange(12), (3, 4), torch.float32)
    try:
        assert t.dtype == torch.float32
        assert torch.equal(t, torch.arange(12.0).reshape(3, 4))
        other = shared_memory.SharedMemory(handle.name)
        view = np.ndarray((3, 4), np.float32, buffer=other.buf)
        assert np.array_equal(view, np.arange(12.0).reshape(3, 4))
        del view
        other.close()
    finally:
        del t
        handle.close()
        handle.unlink()


# ---------------------------------------------------------------------------
# homophily, merge, mpops, utils, random
# ---------------------------------------------------------------------------

MEASURES = ("node_homophily", "edge_homophily", "linkx_homophily",
            "adjusted_homophily", "edge_label_informativeness",
            "node_label_informativeness")


def _graph_pair(seed, n=400, e=2400, classes=5):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, classes, n)
    src = rng.integers(0, n, e)
    # homophilous: half the edges join a node of the same class
    same = rng.random(e) < 0.5
    pool = [np.flatnonzero(y == k) for k in range(classes)]
    dst = np.where(same, [rng.choice(pool[y[s]]) for s in src],
                   rng.integers(0, n - 20, e))  # the last 20: no in-edges
    return (dt.graph((src, dst), num_nodes=n, **CPU),
            dgl_tpu.graph((src, dst), num_nodes=n), y)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("measure", MEASURES)
def test_homophily_measures(measure, seed):
    tg, jg, y = _graph_pair(seed)
    ref = getattr(dgl_tpu, measure, None) or getattr(
        dgl_tpu.homophily, measure)
    got = getattr(dt, measure)(tg, torch.from_numpy(y))
    want = ref(jg, y)
    assert isinstance(got, float)
    assert got == pytest.approx(float(want), rel=1e-12, abs=0)


def test_homophily_on_edge_cases():
    y = np.array([0, 1, 1, 0])
    empty_t = dt.graph((np.array([], np.int64), np.array([], np.int64)),
                       num_nodes=4, **CPU)
    empty_j = dgl_tpu.graph((np.array([], np.int64), np.array([], np.int64)),
                            num_nodes=4)
    for m in ("edge_homophily", "adjusted_homophily", "node_homophily"):
        assert getattr(dt, m)(empty_t, y) == float(
            getattr(dgl_tpu.homophily, m)(empty_j, y)), m


def test_get_long_edges():
    tg, jg, _y = _graph_pair(2)
    got = dt.get_long_edges(tg)
    ref = dgl_tpu.get_long_edges(jg)
    for a, b in zip(got, ref):
        assert a.dtype == torch.int64
        assert np.array_equal(a.numpy(), b)


def test_merge():
    rng = np.random.default_rng(4)
    parts = [(rng.integers(0, n, 3 * n), rng.integers(0, n, 3 * n), n)
             for n in (20, 25, 15)]
    tgs = [dt.graph((s, d), num_nodes=n, **CPU) for s, d, n in parts]
    jgs = [dgl_tpu.graph((s, d), num_nodes=n) for s, d, n in parts]
    feat = rng.normal(size=(20, 3)).astype(np.float32)
    tgs[0].ndata["feat"] = torch.from_numpy(feat)
    jgs[0].ndata["feat"] = jnp.asarray(feat)
    same_graph(dt.merge(tgs), dgl_tpu.merge(jgs), "merge")
    hetero = [_port_hetero(0), _port_hetero(1)]
    same_graph(dt.merge(hetero),
               dgl_tpu.merge([_reference_hetero(0), _reference_hetero(1)]),
               "merge hetero")
    with pytest.raises(dt.DGLError):
        dt.merge([])


@pytest.mark.parametrize("name", dgl_tpu.mpops.__all__)
def test_mpops(name):
    rng = np.random.default_rng(5)
    src, dst = rng.integers(0, 30, 90), rng.integers(0, 30, 90)
    tg = dt.graph((src, dst), num_nodes=30, **CPU)
    jg = dgl_tpu.graph((src, dst), num_nodes=30)
    x = rng.normal(size=(30, 4)).astype(np.float32)
    e = rng.normal(size=(90, 4)).astype(np.float32)
    if name.startswith("copy_u"):
        args = (x,)
    elif name.startswith("copy_e"):
        args = (e,)
    elif name.endswith("_v"):
        args = (x, x[::-1].copy())
    else:
        args = (x, e)
    got = getattr(dt.mpops, name)(tg, *map(torch.from_numpy, args))
    ref = getattr(dgl_tpu.mpops, name)(jg, *map(jnp.asarray, args))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)
    assert getattr(dt.mpops, name) is getattr(dt.ops, name)


def test_filter():
    rng = np.random.default_rng(6)
    ids = rng.integers(0, 100, 40)
    test = rng.integers(0, 120, 500)
    tf = dt.utils.Filter(torch.from_numpy(ids))
    jf = dgl_tpu.utils.Filter(ids)
    for m in ("find_included_indices", "find_excluded_indices"):
        got = getattr(tf, m)(torch.from_numpy(test))
        ref = np.asarray(getattr(jf, m)(test))
        assert got.dtype == torch.int64
        assert np.array_equal(got.numpy(), ref), m


def test_relabel_and_toindex():
    reference_native()  # the reference's numpy fallback sorts instead
    rng = np.random.default_rng(7)
    ids = rng.integers(-5, 1000, 3000)
    uniq, inv = dt.utils.relabel(torch.from_numpy(ids))
    ruq, rinv = dgl_tpu.utils.relabel(ids)
    assert np.array_equal(uniq.numpy(), ruq)
    assert np.array_equal(inv.numpy(), rinv)
    assert np.array_equal(uniq.numpy()[inv.numpy()], ids)
    for x in (3, [1, 2], np.arange(4, dtype=np.int32), torch.arange(3)):
        got = dt.utils.toindex(x)
        ref = dgl_tpu.utils.toindex(np_of(x))
        assert got.dtype == ref.dtype and np.array_equal(got, ref)


def test_checks_and_expand_as_pair():
    a, b = torch.ones(3, 4), torch.ones(2, 4)
    assert dt.utils.expand_as_pair((a, b)) == (a, b)
    dt.utils.check_eq_shape((a, b))
    with pytest.raises(dt.DGLError):
        dt.utils.check_eq_shape((a, torch.ones(2, 5)))


def test_random_draws_the_reference_values():
    for s in (0, 5, 1234):
        dt.seed(s)
        dgl_tpu.seed(s)
        assert dt.random.next_seed() == dgl_tpu.random.next_seed()
        for kw in ({}, {"replace": False}, {"prob": np.arange(1.0, 11.0)}):
            got = dt.random.choice(10, 6, **kw)
            ref = dgl_tpu.random.choice(10, 6, **kw)
            assert np.array_equal(got, ref), kw
        got = dt.random.choice(10, 3, prob=torch.arange(1.0, 11.0))
        ref = dgl_tpu.random.choice(10, 3, prob=np.arange(1.0, 11.0))
        assert np.array_equal(got, ref)
        assert dt.random.get_rng().integers(1 << 30) == \
            dgl_tpu.random.get_rng().integers(1 << 30)
    with pytest.raises(ValueError):
        dt.random.choice(3, 1, prob=np.zeros(3))
    # seed does not touch torch's generator
    torch.manual_seed(9)
    want = torch.rand(3)
    torch.manual_seed(9)
    dt.seed(1)
    assert torch.equal(torch.rand(3), want)


# ---------------------------------------------------------------------------
# chunk tree, sparse optimisers, SAGEConv's precomputed neighbourhood
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("W", [4, 16])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tree_segment_sum(W, seed):
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 40, 60)
    counts[rng.random(60) < 0.25] = 0  # empty segments
    counts[3] = 300  # a long run: several levels
    levels, w = t_tree.build_tree_levels(counts, W=W)
    ref_levels, _ = j_tree.build_tree_levels(counts, W=W)
    assert len(levels) == len(ref_levels)
    for a, b in zip(levels, ref_levels):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    rows = rng.normal(size=(int(counts.sum()), 5)).astype(np.float32)
    got = t_tree.tree_segment_sum(levels, w, torch.from_numpy(rows),
                                  counts.size)
    ref = np.asarray(j_tree.tree_segment_sum(
        [jnp.asarray(x) for x in ref_levels], w, jnp.asarray(rows),
        counts.size))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())
    want = np.zeros((counts.size, 5))
    np.add.at(want, np.repeat(np.arange(counts.size), counts), rows)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_tree_segment_sum_fused_level0_bf16():
    rng = np.random.default_rng(3)
    counts = rng.integers(0, 20, 30)
    table = rng.normal(size=(50, 3)).astype(np.float32)
    src = rng.integers(0, 50, int(counts.sum()))
    levels, w = t_tree.build_tree_levels(counts, W=8, level0_values=src,
                                         level0_oob=50)
    ref_levels, _ = j_tree.build_tree_levels(counts, W=8, level0_values=src,
                                             level0_oob=50)
    for a, b in zip(levels, ref_levels):
        assert np.array_equal(a, b)
    got = t_tree.tree_segment_sum(
        levels, w, torch.from_numpy(table).bfloat16(), counts.size)
    ref = np.asarray(j_tree.tree_segment_sum(
        [jnp.asarray(x) for x in ref_levels], w,
        jnp.asarray(table).astype(jnp.bfloat16), counts.size))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("opt", ["SparseAdagrad", "SparseAdam"])
def test_sparse_optimisers(opt):
    rng = np.random.default_rng(8)
    temb = [dt.nn.NodeEmbedding(40, 6, seed=s, **CPU) for s in (0, 1)]
    jemb = [dgl_tpu.nn.NodeEmbedding(40, 6, seed=s) for s in (0, 1)]
    before = [e.weight.clone() for e in temb]
    held = temb[0].weight  # in place: a holder of the tensor sees steps
    t_opt = getattr(dt.optim, opt)(temb, lr=0.05)
    j_opt = getattr(dgl_tpu.optim, opt)(jemb, lr=0.05)
    touched = np.zeros((2, 40), bool)
    for _ in range(3):
        batch = []
        for i in range(2):
            ids = rng.integers(0, 30, 12)  # rows 30..39 never touched
            ids[:3] = ids[3]  # repeated ids
            touched[i, ids] = True
            batch.append((ids, rng.normal(size=(12, 6)).astype(np.float32)))
        t_opt.step([(torch.from_numpy(i), torch.from_numpy(g))
                    for i, g in batch])
        j_opt.step([(jnp.asarray(i), jnp.asarray(g)) for i, g in batch])
        t_opt.zero_grad()
    assert held is temb[0].weight
    for i in range(2):
        got, ref = temb[i].weight.numpy(), np.asarray(jemb[i].weight)
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
        assert np.array_equal(got[~touched[i]],
                              before[i].numpy()[~touched[i]])
        assert not np.array_equal(got[touched[i]],
                                  before[i].numpy()[touched[i]])


@pytest.mark.parametrize("weighted", [False, True])
def test_precompute_sage_neigh(weighted):
    rng = np.random.default_rng(9)
    n, e = 40, 160
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    tg = dt.graph((src, dst), num_nodes=n, **CPU)
    jg = dgl_tpu.graph((src, dst), num_nodes=n)
    x = rng.normal(size=(n, 7)).astype(np.float32)
    w = rng.random((e, 1)).astype(np.float32) if weighted else None
    tw = None if w is None else torch.from_numpy(w)
    jw = None if w is None else jnp.asarray(w)
    got = dt.nn.precompute_sage_neigh(tg, torch.from_numpy(x), tw)
    ref = np.asarray(dgl_tpu.nn.precompute_sage_neigh(jg, jnp.asarray(x),
                                                      jw))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())

    jconv = dgl_tpu.nn.SAGEConv(7, 5, "mean")
    params = jconv.init(jax.random.PRNGKey(0), jg, jnp.asarray(x),
                        precomputed_neigh=jnp.asarray(ref))
    tconv = dt.nn.SAGEConv(7, 5, "mean", **CPU)
    tconv.load_state_dict(dt.from_flax_params(params))
    out = tconv(tg, torch.from_numpy(x), precomputed_neigh=got)
    want = np.asarray(jconv.apply(params, jg, jnp.asarray(x),
                                  precomputed_neigh=jnp.asarray(ref)))
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    # the precomputed table gives the layer's own output
    full = tconv(tg, torch.from_numpy(x), edge_weight=tw)
    np.testing.assert_allclose(out.detach().numpy(), full.detach().numpy(),
                               rtol=1e-5, atol=1e-5)


def test_precomputed_neigh_needs_the_mean_aggregator():
    g = dt.graph((np.array([0, 1]), np.array([1, 2])), num_nodes=3, **CPU)
    conv = dt.nn.SAGEConv(4, 2, "gcn", **CPU)
    with pytest.raises(dt.DGLError, match="mean"):
        conv(g, torch.ones(3, 4), precomputed_neigh=torch.ones(3, 4))


# ---------------------------------------------------------------------------
# profiler, health, config, logging, base, aliases
# ---------------------------------------------------------------------------


def test_stage_timer_and_timed_stage():
    timer = tprof.StageTimer()
    with timer.stage("a"):
        time.sleep(0.01)
    with timer.stage("a"):
        pass
    assert list(tprof.timed_stage(timer, "it", range(3))) == [0, 1, 2]
    s = timer.summary()
    assert s["a"]["count"] == 2 and s["a"]["total_s"] >= 0.01
    assert s["it"]["count"] == 4  # three items and the end
    assert set(s) == {"a", "it"} and "StageTimer(" in repr(timer)
    timer.reset()
    assert timer.summary() == {}


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # no CUDA activity on the CPU
        with tprof.profile_trace(str(tmp_path / "trace")):
            torch.ones(64, 64).matmul(torch.ones(64, 64)).sum()
    (path,) = glob.glob(str(tmp_path / "trace" / "*.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in ev.get("name", "") for ev in events)


def test_run_with_watchdog():
    wd = dt.health.run_with_watchdog
    assert wd(lambda: 3, 5) == 3
    assert wd(lambda: time.sleep(5), 1, fallback=lambda: "fell back") == \
        "fell back"
    with pytest.raises(dt.health.DeviceTimeout):
        wd(lambda: time.sleep(5), 1)


def test_check_devices(monkeypatch):
    assert dt.health.check_devices(60, device="cpu") is True
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    assert dt.health.check_devices(60) is False


def test_config_is_the_reference_config(monkeypatch):
    import importlib

    # the packages bind ``config`` to the Config object, over the module
    jconfig = importlib.import_module("dgl_tpu.config")
    assert dataclasses.asdict(dt.get_config()) == dataclasses.asdict(
        jconfig.Config())
    for k, v in (("DGL_TPU_NO_NATIVE", "1"), ("DGL_TPU_PREFETCH", "5"),
                 ("DGL_TPU_DOWNLOAD_DIR", "/x"), ("DGL_TPU_LOG_DEBUG", "1"),
                 ("DGL_TPU_PAD_MULTIPLE", "16")):
        monkeypatch.setenv(k, v)
    got = dataclasses.asdict(importlib.import_module(
        "dgl_tpu_torch.config").Config())
    assert got == dataclasses.asdict(jconfig.Config())
    assert got["num_prefetch"] == 5 and got["use_native"] is False


def test_logger_and_warning():
    import logging

    assert dt.get_logger() is logging.getLogger("dgl-tpu")
    assert dt.base.logger is dgl_tpu.base.logger
    dt.enable_verbose_logging()
    assert dt.get_logger().level == logging.DEBUG
    assert issubclass(dt.DGLWarning, UserWarning)
    with pytest.warns(dt.DGLWarning, match="careful"):
        dt.base.dgl_warning("careful")


def test_last_public_names():
    assert dt.DGLHeteroGraph is dt.Graph
    assert dt.fn is dt.function
    assert dt.edge_softmax is dt.ops.edge_softmax
    assert dt.random.seed is dt.seed
    assert "parallel" in dt.__all__
    assert dt.apply_each({"a": 1, "b": 2}, lambda v, k: v * k, 3) == {
        "a": 3, "b": 6}
    assert dt.apply_each(4, lambda v: v + 1) == 5
    assert dt.function.copy_src("h", "m").name == "copy_u"
    assert dt.function.copy_edge("h", "m").name == "copy_e"
    assert dt.function.base.TargetCode == \
        dgl_tpu.function.base.TargetCode
    assert dt.nn.conv.EdgeWeightNorm is dt.nn.EdgeWeightNorm
    assert dt.storages.TensorStorage is dt.graphbolt.NumpyFeature
    assert dt.storages.DiskStorage is dt.graphbolt.DiskBasedFeature
    assert dt.dataloading.DistDataLoader is dt.dataloading.DataLoader
    assert dt.dataloading.DistNodeDataLoader is \
        dt.distributed.DistNodeDataLoader
