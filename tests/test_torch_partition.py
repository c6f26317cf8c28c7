"""The port's partitioner, partition files, halo partitions and graph files
(``dgl_tpu_torch.distributed``, ``partition_mod``, ``data.serialize``)
against ``dgl_tpu``, on the same numpy graphs.

The assignment is host numpy over ``csrc/host_ops.cpp`` on both sides
(the reference through ``dgl_tpu/_native``, the port through
``dgl_tpu_torch/_host.py``), so parts, orders, subgraphs and files are held
exactly; float frames at rtol = atol = 1e-6 (copies). The reference falls
back to an approximate numpy matching when its native library fails to
load: ``reference_native`` loads it under a lock first and fails the test
if it will not load.
"""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dgl_tpu
from dgl_tpu import _native
from dgl_tpu import partition_mod as jpm
from dgl_tpu.data import serialize as jser
from dgl_tpu.distributed import graph_partition_book as jbook
from dgl_tpu.distributed import partition as JP
from dgl_tpu.transforms import functional as JF
import dgl_tpu_torch as dt
from dgl_tpu_torch import _host
from dgl_tpu_torch import partition_mod as tpm
from dgl_tpu_torch.data import serialize as tser
from dgl_tpu_torch.distributed import partition as TP
from dgl_tpu_torch.transforms import functional as TF

from test_torch_graph_utils import (assert_same, hetero_pair, homo_pair,
                                    np_of, same_graph)
from test_torch_sampling import reference_native


@pytest.fixture(autouse=True, scope="module")
def _reference_native():
    reference_native()


def zipf_edges(n, e, seed):
    """zipf(s=1) sources, uniform destinations (bench.py's recipe)."""
    rng = np.random.default_rng(seed)
    w = 1.0 / np.arange(1, n + 1)
    return rng.choice(n, e, p=w / w.sum()), rng.integers(0, n, e)


def sbm_edges(n, e, seed, blocks=4, p_in=0.9):
    """A planted partition: most edges inside one of ``blocks`` groups."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e)
    same = rng.random(e) < p_in
    size = n // blocks
    inside = (src // size) * size + rng.integers(0, size, e)
    dst = np.where(same, np.minimum(inside, n - 1), rng.integers(0, n, e))
    return src, dst


GRAPHS = {"sbm200": (200, 1200, sbm_edges), "zipf3000": (3000, 15000,
                                                         zipf_edges)}


def pair(name, seed=0):
    n, e, make = GRAPHS[name]
    src, dst = make(n, e, seed)
    return (dgl_tpu.graph((src, dst), num_nodes=n),
            dt.graph((src, dst), num_nodes=n, device="cpu"))


@pytest.fixture(scope="module")
def graphs():
    return {name: pair(name) for name in GRAPHS}


# ---------------------------------------------------------------------------
# the host library's three partitioner functions
# ---------------------------------------------------------------------------


def _pairs(seed, n=400, m=3000):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, n, m).astype(np.int32),
            rng.integers(0, n, m).astype(np.int32), n, rng)


BINDINGS = {
    "hem_match": lambda mod, r, c, n, rng: mod.hem_match(r, c, n),
    "aggregate_csr": lambda mod, r, c, n, rng: mod.aggregate_csr(
        r, c, None, n),
    "aggregate_csr weights, diagonal kept": lambda mod, r, c, n, rng: (
        mod.aggregate_csr(r, c, rng.random(r.size).astype(np.float32), n,
                          skip_diag=False)),
    "aggregate_csr row_cap": lambda mod, r, c, n, rng: mod.aggregate_csr(
        r, c, rng.random(r.size).astype(np.float32), n, row_cap=3),
    "kway_gains": lambda mod, r, c, n, rng: mod.kway_gains(
        *mod.aggregate_csr(r, c, rng.random(r.size).astype(np.float32),
                           n), rng.integers(0, 5, n), 5),
    "kway_gains unit weights": lambda mod, r, c, n, rng: mod.kway_gains(
        *mod.aggregate_csr(r, c, None, n)[:2], None, rng.integers(0, 3, n),
        3),
}


@pytest.mark.parametrize("name", sorted(BINDINGS))
def test_binding_matches_reference_native(name):
    """Each ``_host.py`` binding against ``dgl_tpu._native``'s on the same
    arrays: exact (both sum in input order)."""
    got = BINDINGS[name](_host, *_pairs(1))
    ref = BINDINGS[name](_native, *_pairs(1))
    assert_same(got, ref, name)


def test_bindings_refuse_what_the_cpp_would_read_out_of_bounds():
    """The C++ indexes with ids unchecked; the bindings raise first (the
    reference's reads out of bounds). And ``kway_gains`` needs two parts
    (the reference falls back to numpy below that)."""
    r, c, n, _ = _pairs(2)
    indptr, cols, w = _host.aggregate_csr(r, c, None, n)
    parts = np.zeros(n, np.int64)
    calls = [lambda: _host.kway_gains(indptr, cols, w, parts, 1),
             lambda: _host.kway_gains(indptr, cols, w, parts + 3, 3),
             lambda: _host.kway_gains(indptr, cols, w, parts[:-1], 3),
             lambda: _host.hem_match(r, c, n - 1),
             lambda: _host.hem_match(r, c[:-1], n),
             lambda: _host.aggregate_csr(r - 1, c, None, n),
             lambda: _host.aggregate_csr(r, c, w, n)]
    for call in calls:
        with pytest.raises(ValueError):
            call()


@pytest.mark.parametrize("wmax", [None, 8.0])
def test_coarsen_matches(graphs, wmax):
    """Two levels of heavy-edge matching (the second over weighted coarse
    edges, where the sort order matters), with and without the cluster
    weight cap: the same coarse graphs and mappings, exactly."""
    jg, tg = graphs["zipf3000"]
    ja, ta = JP._sym_adj(jg), TP._sym_adj(tg)
    jw = tw = np.ones(ja.shape[0])
    for _ in range(2):
        ja, jw, jmap = JP._coarsen(ja, jw, wmax=wmax)
        ta, tw, tmap = TP._coarsen(ta, tw, wmax=wmax)
        assert np.array_equal(tmap, jmap)
        assert_same(tw, jw)
        assert (ta != ja).nnz == 0 and ta.shape == ja.shape


# ---------------------------------------------------------------------------
# the assignment
# ---------------------------------------------------------------------------


def _options(variant, n):
    if variant == "balance_edges":
        return dict(balance_edges=True)
    if variant == "balance_ntypes":
        return dict(balance_ntypes=np.arange(n) % 3)
    return {}


@pytest.mark.parametrize("variant", ["plain", "balance_edges",
                                     "balance_ntypes"])
@pytest.mark.parametrize("k", [2, 3, 8])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_metis_assignment_matches(graphs, name, k, variant):
    """Recursive bisection (both graphs lie below the k-way threshold):
    the same parts, exactly."""
    jg, tg = graphs[name]
    kw = _options(variant, jg.num_nodes())
    got = TP.metis_partition_assignment(tg, k, **kw)
    ref = JP.metis_partition_assignment(jg, k, **kw)
    assert got.dtype == np.int64 and got.shape == (jg.num_nodes(),)
    assert np.array_equal(got, ref)
    assert set(np.unique(got)) == set(range(k))


def _kway_low(monkeypatch):
    for mod in (JP, TP):
        monkeypatch.setattr(mod, "_KWAY_EDGE_THRESHOLD", 1_000)
        monkeypatch.setattr(mod, "_KWAY_COARSE_TO", 300)


@pytest.mark.parametrize("k", [3, 8])
def test_kway_path_matches(graphs, monkeypatch, k):
    """The coarsen-once k-way path, its thresholds patched low in both
    modules so the 3,000-node graph takes it."""
    _kway_low(monkeypatch)
    jg, tg = graphs["zipf3000"]
    got = TP.metis_partition_assignment(tg, k, balance_edges=True)
    assert np.array_equal(got,
                          JP.metis_partition_assignment(jg, k,
                                                        balance_edges=True))


@pytest.mark.parametrize("stride", ["1", "2"])
def test_kway_workdir_checkpoints_and_resumes(graphs, monkeypatch, tmp_path,
                                              stride):
    """With ``DGL_TPU_KWAY_WORKDIR`` every level spills and the run
    resumes from its checkpoints; stride 2 projects every other level
    straight through. Each run equals the reference's."""
    _kway_low(monkeypatch)
    monkeypatch.setenv("DGL_TPU_KWAY_REFINE_STRIDE", stride)
    jg, tg = graphs["zipf3000"]
    ref = JP.metis_partition_assignment(jg, 4)
    monkeypatch.setenv("DGL_TPU_KWAY_WORKDIR", str(tmp_path / "kway"))
    first = TP.metis_partition_assignment(tg, 4)
    files = sorted(os.listdir(tmp_path / "kway"))
    assert "coarsest.npz" in files and "coarse_parts.npy" in files
    resumed = TP.metis_partition_assignment(tg, 4)
    assert np.array_equal(first, ref) and np.array_equal(resumed, ref)


def test_random_assignment_and_edge_cut(graphs):
    jg, tg = graphs["zipf3000"]
    for seed in (0, 5):
        got = TP.random_partition_assignment(tg, 6, seed=seed)
        assert np.array_equal(got,
                              JP.random_partition_assignment(jg, 6, seed))
        assert TP.edge_cut(tg, got) == JP.edge_cut(jg, got)
    assert np.array_equal(TP.metis_partition_assignment(tg, 1),
                          np.zeros(jg.num_nodes(), np.int64))


def test_hetero_assignment_matches():
    jg, tg = hetero_pair(frames=False)
    got = TP.hetero_partition_assignment(tg, 3)
    assert_same(got, JP.hetero_partition_assignment(jg, 3))


def test_partition_book_and_rank():
    ranges = np.array([0, 4, 4, 10])
    tb = dt.distributed.RangePartitionBook(ranges, 3, meta={"a": 1})
    jb = jbook.RangePartitionBook(ranges, 3, meta={"a": 1})
    ids = np.array([0, 3, 4, 9])
    assert_same(tb.nid2partid(ids), jb.nid2partid(ids))
    assert_same(tb.nid2localnid(ids[2:], 2), jb.nid2localnid(ids[2:], 2))
    for p in range(3):
        assert_same(tb.partid2nids(p), jb.partid2nids(p))
        assert tb.num_nodes(p) == jb.num_nodes(p)
    assert tb.metadata() == jb.metadata() and tb.num_nodes() == 10
    assert tb.num_partitions == 3 and tb.meta == {"a": 1}
    assert tb.partid == 0  # no process group: rank 0 of 1
    assert dt.distributed.get_world_size() == 1
    assert dt.distributed.GraphPartitionBook is dt.distributed.RangePartitionBook
    # no coordinator given or in the environment: still rank 0 of 1
    dt.distributed.dist_context.initialize()
    assert dt.distributed.get_rank() == 0
    assert dt.distributed.get_world_size() == 1


# ---------------------------------------------------------------------------
# per-part files
# ---------------------------------------------------------------------------


def _same_loaded(tg, jg, what):
    """A graph the port loaded against one the reference loaded: schema,
    relations and frame values (the reference keeps int64 frames as
    int32, JAX without x64)."""
    same_graph(tg, jg, what, batch=False)


@pytest.mark.parametrize("method,hops", [("metis", 1), ("random", 2)])
def test_partition_graph_files_load_in_either_package(graphs, tmp_path,
                                                       method, hops):
    """``partition_graph`` writes the same book, assignment and parts as
    the reference; each package's files load in the other."""
    jg, tg = graphs["sbm200"]
    x = np.random.default_rng(3).normal(size=(jg.num_nodes(), 4)).astype(
        np.float32)
    jg.ndata["x"], tg.ndata["x"] = jnp.asarray(x), torch.from_numpy(x)
    tdir, jdir = str(tmp_path / "t"), str(tmp_path / "j")
    got = TP.partition_graph(tg, "g", 4, tdir, part_method=method,
                             num_hops=hops, return_mapping=True)
    ref = JP.partition_graph(jg, "g", 4, jdir, part_method=method,
                             num_hops=hops, return_mapping=True)
    assert_same(got, ref)
    with open(os.path.join(tdir, "g.json")) as f, open(
            os.path.join(jdir, "g.json")) as h:
        assert json.load(f) == json.load(h)
    assert_same(TP.load_assignment(tdir), JP.load_assignment(jdir))
    tbook = TP.load_partition_book(tdir)
    assert_same(tbook.nid2partid(np.arange(jg.num_nodes())),
                JP.load_partition_book(jdir).nid2partid(
                    np.arange(jg.num_nodes())))
    for p in range(4):
        t_own, _ = TP.load_partition(tdir, p, device="cpu")
        j_own, _ = JP.load_partition(jdir, p)
        _same_loaded(t_own, j_own, f"part {p}")
        # across: the port reads the reference's file and vice versa
        t_other, _ = TP.load_partition(os.path.join(jdir, "g.json"), p,
                                       device="cpu")
        _same_loaded(t_other, j_own, f"reference part {p} in the port")
        j_other, _ = JP.load_partition(tdir, p)
        _same_loaded(t_own, j_other, f"port part {p} in the reference")
    del jg.ndata["x"], tg.ndata["x"]


def test_partition_hetero_graph_files(tmp_path):
    jg, tg = hetero_pair()
    got = TP.partition_hetero_graph(tg, "h", 2, str(tmp_path / "t"))
    ref = JP.partition_hetero_graph(jg, "h", 2, str(tmp_path / "j"))
    assert_same(got, ref)
    for p in range(2):
        t_part, _ = tser.load_graphs(str(tmp_path / "t" / f"part{p}.npz"),
                                     device="cpu")
        j_part, _ = jser.load_graphs(str(tmp_path / "j" / f"part{p}.npz"))
        _same_loaded(t_part[0], j_part[0], f"hetero part {p}")
        j_cross, _ = jser.load_graphs(str(tmp_path / "t" / f"part{p}.npz"))
        _same_loaded(t_part[0], j_cross[0], f"hetero part {p} across")


# ---------------------------------------------------------------------------
# graph and tensor files
# ---------------------------------------------------------------------------


def _block_pair():
    rng = np.random.default_rng(3)
    src, dst = rng.integers(0, 10, 25), rng.integers(0, 4, 25)
    jb = dgl_tpu.create_block((src, dst), 10, 4)
    tb = dt.create_block((src, dst), 10, 4, device="cpu")
    x = rng.normal(size=(10, 2)).astype(np.float32)
    y = rng.normal(size=(4, 2)).astype(np.float32)
    jb.srcdata["x"], tb.srcdata["x"] = jnp.asarray(x), torch.from_numpy(x)
    jb.dstdata["y"], tb.dstdata["y"] = jnp.asarray(y), torch.from_numpy(y)
    return jb, tb


SERIALIZED = {"homogeneous": lambda: homo_pair(),
              "padded": lambda: homo_pair(padded=True),
              "heterogeneous": lambda: hetero_pair(),
              "block": _block_pair}


@pytest.mark.parametrize("idx_list", [None, [2, 0]])
def test_graph_files_round_trip(tmp_path, idx_list):
    """Every kind of graph and a label dict, each package writing its own
    file from the same graphs: each file reads the same in either package
    (relations come back in sorted order in both); labels, the file's
    description."""
    pairs = {k: make() for k, make in SERIALIZED.items()}
    names = sorted(pairs)
    labels = np.arange(6, dtype=np.int64).reshape(2, 3)
    tpath, jpath = str(tmp_path / "port.bin"), str(tmp_path / "ref.bin")
    tser.save_graphs(tpath, [pairs[k][1] for k in names],
                     {"y": torch.from_numpy(labels)})
    jser.save_graphs(jpath, [pairs[k][0] for k in names],
                     {"y": jnp.asarray(labels)})
    for t_file, j_file in ((tpath, jpath), (jpath, tpath)):
        tgs, tlab = tser.load_graphs(t_file, idx_list, device="cpu")
        jgs, jlab = jser.load_graphs(j_file, idx_list)
        assert len(tgs) == len(jgs) == (4 if idx_list is None else 2)
        for i, (tg2, jg2) in enumerate(zip(tgs, jgs)):
            _same_loaded(tg2, jg2, f"{t_file} graph {i}")
        assert_same(tlab, jlab)
        assert_same(tser.load_labels(t_file, device="cpu"),
                    jser.load_labels(j_file))
    meta = tser.storage_metadata(tpath)
    assert meta.num_graphs == 4 and meta.labels == {"y": None}
    assert meta.metadata == jser.storage_metadata(jpath).metadata


def test_tensor_and_info_files(tmp_path):
    t = {"a": torch.arange(5), "b": torch.ones(2, 3)}
    tser.save_tensors(str(tmp_path / "t.npz"), t)
    assert_same(tser.load_tensors(str(tmp_path / "t.npz"), device="cpu"),
                jser.load_tensors(str(tmp_path / "t.npz")))
    tser.save_info(str(tmp_path / "d" / "info.json"), {"n": 3})
    assert jser.load_info(str(tmp_path / "d" / "info.json")) == {"n": 3}
    assert tser.load_info(str(tmp_path / "d" / "info.json")) == {"n": 3}
    with pytest.raises(dt.DGLError):
        tser.load_graphs(str(tmp_path / "missing.npz"), device="cpu")


# ---------------------------------------------------------------------------
# halo partitions, orders and Cluster-GCN
# ---------------------------------------------------------------------------


def _with_feats(jg, tg, seed=4):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(jg.num_nodes(), 3)).astype(np.float32)
    w = rng.normal(size=(jg.num_edges(),)).astype(np.float32)
    jg.ndata["x"], tg.ndata["x"] = jnp.asarray(x), torch.from_numpy(x)
    jg.edata["w"], tg.edata["w"] = jnp.asarray(w), torch.from_numpy(w)
    return jg, tg


@pytest.mark.parametrize("hops,reshuffle", [(0, False), (1, True),
                                            (2, False)])
def test_partition_graph_with_halo(hops, reshuffle):
    jg, tg = _with_feats(*pair("sbm200", seed=1))
    node_part = np.random.default_rng(5).integers(0, 3, jg.num_nodes())
    got, gn, ge = tpm.partition_graph_with_halo(tg, node_part, hops,
                                                reshuffle)
    ref, rn, re = jpm.partition_graph_with_halo(jg, node_part, hops,
                                                reshuffle)
    assert sorted(got) == sorted(ref)
    for p in ref:
        same_graph(got[p], ref[p], f"part {p}", batch=False)
    if reshuffle:
        assert_same(gn, rn)
        assert_same(ge, re)
    else:
        assert gn is None and ge is None


def test_reshuffle_and_metis_partition():
    jg, tg = _with_feats(*pair("sbm200", seed=2))
    node_part = np.random.default_rng(6).integers(0, 4, jg.num_nodes())
    g2, p2 = tpm.reshuffle_graph(tg, node_part)
    j2, q2 = jpm.reshuffle_graph(jg, node_part)
    same_graph(g2, j2, "reshuffled", batch=False)
    assert_same(p2, q2)
    got = dt.metis_partition(tg, 3, extra_cached_hops=1, reshuffle=True,
                             balance_edges=True)
    ref = dgl_tpu.metis_partition(jg, 3, extra_cached_hops=1, reshuffle=True,
                                  balance_edges=True)
    for p in ref:
        same_graph(got[p], ref[p], f"metis part {p}", batch=False)
    with pytest.raises(dt.DGLError):
        tpm.metis_partition(tg, 2, mode="nope")
    with pytest.raises(dt.DGLError):
        tpm.partition_graph_with_halo(tg, node_part[:-1], 1)


def test_metis_order_and_reorder_graph(graphs):
    """``metis_perm`` is the stable argsort of the assignment, on the
    graph's device; ``reorder_graph(g, "metis")`` relabels by it."""
    jg, tg = graphs["zipf3000"]
    perm = TF.metis_perm(tg, 5)
    assert perm.dtype == torch.int64 and perm.device == tg.device
    assert np.array_equal(np_of(perm), JF.metis_perm(jg, 5))
    jg2, tg2 = _with_feats(*pair("sbm200", seed=3))
    got = TF.reorder_graph(tg2, "metis", permute_config={"k": 4})
    ref = JF.reorder_graph(jg2, "metis", permute_config={"k": 4})
    same_graph(got, ref, "reorder_graph(metis)", batch=False)


def test_cluster_gcn_sampler_matches():
    jg, tg = _with_feats(*pair("zipf3000", seed=4))
    from dgl_tpu.dataloading import ClusterGCNSampler as JS

    ts = dt.dataloading.ClusterGCNSampler(tg, 12)
    js = JS(jg, 12)
    assert_same(ts.part_nodes, js.part_nodes)
    for ids in ([3], [0, 7, 11], np.array([5, 2])):
        same_graph(ts.sample(tg, ids), js.sample(jg, ids), f"parts {ids}",
                   batch=False)
    loader = dt.dataloading.DataLoader(tg, np.arange(12), ts, batch_size=5,
                                       shuffle=True, seed=0, device="cpu")
    seen = np.concatenate([np_of(sg.ndata[dt.NID]) for sg in loader])
    assert np.array_equal(np.sort(seen), np.arange(tg.num_nodes()))
