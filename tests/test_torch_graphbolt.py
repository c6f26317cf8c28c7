"""The port's GraphBolt (``dgl_tpu_torch.graphbolt``) against
``dgl_tpu.graphbolt``: item sets and samplers, the feature stores and
caches, the on-disk dataset and its files, the loader, the datapipe
utilities and the id primitives. The samplers, the sampling graph and
the device backend are in ``test_torch_graphbolt_sampling.py``.

Each case builds its inputs once with numpy from a seed, runs the
reference on CPU JAX and the port with ``device="cpu"``, and compares.
Ids, batches, cache contents, hit and miss counts, files, metadata and
fetched features are held exactly (both sides index the same float32
rows); the shuffles are the same numpy draws on both sides. The
reference's host library is loaded first under
``test_torch_sampling.reference_native``'s lock: without it the
reference reads features through its mmap fallback and unique-and-relabel
through numpy.
"""
import json
import os
import re
import zipfile

import numpy as np
import pytest
import torch

import dgl_tpu
from dgl_tpu import _native
from dgl_tpu import graphbolt as jgb
import dgl_tpu_torch as dt
from dgl_tpu_torch import _host
from dgl_tpu_torch import graphbolt as tgb
from dgl_tpu_torch.graph import unique_first_occurrence

from test_torch_graph_utils import np_of
from test_torch_sampling import reference_native


@pytest.fixture(autouse=True, scope="module")
def _reference_native():
    reference_native()


def exact(got, ref, what="value"):
    """Arrays equal element for element (floats too), tuples, lists and
    dicts recursively, scalars equal."""
    if isinstance(ref, dict):
        assert set(got) == set(ref), (what, set(got), set(ref))
        for k in ref:
            exact(got[k], ref[k], f"{what}[{k!r}]")
        return
    if isinstance(ref, (tuple, list)):
        assert len(got) == len(ref), what
        for i, (a, b) in enumerate(zip(got, ref)):
            exact(a, b, f"{what}[{i}]")
        return
    if isinstance(ref, (bool, int, float, str, type(None), np.bool_)):
        assert got == ref, (what, got, ref)
        return
    g, r = np_of(got), np.asarray(ref)
    assert g.shape == r.shape, (what, g.shape, r.shape)
    assert np.array_equal(g, r), (what, g, r)


def graph_arrays(n=100, e=1000, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, n, e), rng.integers(0, n, e)


@pytest.fixture(scope="module")
def graphs():
    src, dst = graph_arrays()
    return (dgl_tpu.graph((src, dst), num_nodes=100),
            dt.graph((src, dst), num_nodes=100, device="cpu"))


# ---------------------------------------------------------------------------
# the reference's names, and the raises of what is not ported yet
# ---------------------------------------------------------------------------


def _cases_text():
    here = os.path.dirname(os.path.abspath(__file__))
    text = ""
    for name in ("test_torch_graphbolt.py",
                 "test_torch_graphbolt_sampling.py"):
        with open(os.path.join(here, name), encoding="utf-8") as f:
            text += f.read()
    return text


def test_every_reference_name_has_a_port_and_a_case():
    assert set(jgb.__all__) == set(tgb.__all__)
    text = _cases_text()
    for name in jgb.__all__:
        assert hasattr(tgb, name), name
    # a case calls each on the port, as tgb.<name> or, in a loop over both
    # packages, m.<name>
    missing = [n for n in jgb.__all__
               if not re.search(rf"\b(tgb|m)\.{n}\b", text)]
    assert not missing, missing


def _coop_meshes():
    """The reference's 8-device gp mesh and the port's 8-part one-process
    mesh on the CPU."""
    from dgl_tpu.parallel import create_mesh as jmesh
    from dgl_tpu_torch.parallel import create_mesh as tmesh

    return jmesh((8,), ("gp",)), tmesh((8,), ("gp",), device="cpu")


def _coop_table(seed=60, n=37, f=3):
    rng = np.random.default_rng(seed)
    feat = rng.normal(size=(n, f)).astype(np.float32)
    ids = rng.integers(0, n, (8, 5))
    return feat, ids


def _coop_shard_feature_table():
    jm, tm = _coop_meshes()
    feat, _ = _coop_table()
    jr, jt = jgb.shard_feature_table(jm, feat)
    tr, tt = tgb.shard_feature_table(tm, torch.from_numpy(feat))
    exact(tr, np.asarray(jr), "ranges")
    exact(tt, np.asarray(jt), "table")


def _coop_fetcher():
    """Two batches through the stage: input nodes (not a multiple of the
    part count), then seeds alone."""
    import jax.numpy as jnp

    jm, tm = _coop_meshes()
    feat, ids = _coop_table()
    jtab = {"feat": jgb.shard_feature_table(jm, feat)}
    ttab = {"feat": tgb.shard_feature_table(tm, torch.from_numpy(feat))}
    batches = [dict(input_nodes=ids.reshape(-1)[:23]),
               dict(seeds=ids.reshape(-1)[5:12])]
    ref = list(jgb.CooperativeFeatureFetcher(
        [jgb.MiniBatch(**{k: jnp.asarray(v) for k, v in b.items()})
         for b in batches], jm, jtab))
    got = list(tgb.CooperativeFeatureFetcher(
        [tgb.MiniBatch(**{k: torch.from_numpy(v) for k, v in b.items()})
         for b in batches], tm, ttab))
    for g, r, b in zip(got, ref, batches):
        want = feat[next(iter(b.values()))]
        exact(g.node_features["feat"], np.asarray(r.node_features["feat"]))
        exact(g.node_features["feat"], want)


def _coop_pull_and_grad(conv):
    """The pull (and its gradient in the table) against the reference's,
    through ``CooperativeConvFunction.apply`` or a ``CooperativeConv``."""
    import jax
    import jax.numpy as jnp

    jm, tm = _coop_meshes()
    feat, ids = _coop_table()
    jr, jt = jgb.shard_feature_table(jm, feat)
    tr, tt = tgb.shard_feature_table(tm, torch.from_numpy(feat))
    cot = np.random.default_rng(61).normal(size=(8, 5, 3)).astype(np.float32)
    if conv:
        jcall, tcall = jgb.CooperativeConv(jm), tgb.CooperativeConv(tm)
    else:
        def jcall(r, t, i):
            return jgb.CooperativeConvFunction.apply(jm, r, t, i)

        def tcall(r, t, i):
            return tgb.CooperativeConvFunction.apply(tm, r, t, i)
    ref = jcall(jr, jt, jnp.asarray(ids))
    jgrad = jax.grad(lambda t: jnp.sum(jcall(jr, t, jnp.asarray(ids))
                                       * cot))(jt)
    tt = tt.clone().requires_grad_(True)
    got = tcall(tr, tt, torch.from_numpy(ids))
    exact(got, np.asarray(ref), "rows")
    exact(got, feat[ids], "rows against the table")
    (got * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(np_of(tt.grad), np.asarray(jgrad),
                               rtol=1e-5, atol=1e-5 * np.abs(
                                   np.asarray(jgrad)).max())


@pytest.mark.parametrize("case", [
    _coop_shard_feature_table, _coop_fetcher,
    lambda: _coop_pull_and_grad(conv=False),
    lambda: _coop_pull_and_grad(conv=True),
], ids=["shard_feature_table", "CooperativeFeatureFetcher",
        "CooperativeConvFunction", "CooperativeConv"])
def test_cooperative_names_raise_naming_a11(case):
    """Each cooperative name on an 8-part one-process mesh against the
    reference on its 8-device mesh: rows exact, gradients at 1e-5. (The
    name is kept from when these names raised naming ROADMAP queue A11.)"""
    case()


def builtin_pair(name, tmp_path, monkeypatch):
    """``BuiltinDataset(name)`` materialised from each package's zoo into a
    directory of its own (each zoo's default download directory too)."""
    out = {}
    for side, m, kw in (("jax", jgb, {}), ("torch", tgb, {"device": "cpu"})):
        monkeypatch.setenv("DGL_TPU_DOWNLOAD_DIR",
                           str(tmp_path / f"zoo_{side}"))
        root = tmp_path / side
        out[side] = (m.BuiltinDataset(name, root=str(root), **kw),
                     root / name)
    return out["torch"], out["jax"]


def same_written_dataset(got_dir, ref_dir):
    """The same files, ``metadata.json`` equal, every array equal; the
    labels are int64 in the port, int32 in the reference."""
    files = sorted(os.listdir(ref_dir))
    assert sorted(os.listdir(got_dir)) == files
    with open(got_dir / "metadata.json") as f, \
            open(ref_dir / "metadata.json") as g:
        assert json.load(f) == json.load(g)
    for name in files:
        if not name.endswith(".npy"):
            continue
        got, ref = np.load(got_dir / name), np.load(ref_dir / name)
        if name == "labels.npy":
            assert (got.dtype, ref.dtype) == (np.int64, np.int32)
        else:
            assert got.dtype == ref.dtype, name
        assert np.array_equal(got, ref), name


def test_builtin_dataset_zoo_raises_naming_a10(tmp_path, monkeypatch):
    """The zoo's names materialise in both packages; the names the zoo
    lacks raise in both."""
    (ds, got_dir), (ref, ref_dir) = builtin_pair("cora", tmp_path,
                                                 monkeypatch)
    same_written_dataset(got_dir, ref_dir)
    assert ds.meta["num_classes"] == ref.meta["num_classes"] == 7
    # the reference's zoo defines no OGB class: both fail the same way
    for name in ("ogbn-arxiv", "ogbn-products"):
        with pytest.raises(AttributeError):
            jgb.BuiltinDataset(name, root=str(tmp_path))
        with pytest.raises(AttributeError):
            tgb.BuiltinDataset(name, root=str(tmp_path), device="cpu")
    for m, kw in ((jgb, {}), (tgb, {"device": "cpu"})):
        with pytest.raises(Exception):
            m.BuiltinDataset("not-a-dataset", root=str(tmp_path), **kw)


@pytest.mark.parametrize("name", ["citeseer", "pubmed"])
def test_builtin_dataset_materialises_from_the_zoo(name, tmp_path,
                                                   monkeypatch):
    """Written by each package from its zoo, then loaded: the files, the
    graph, the splits and the features agree with the zoo's dataset."""
    (ds, got_dir), (ref, ref_dir) = builtin_pair(name, tmp_path,
                                                 monkeypatch)
    same_written_dataset(got_dir, ref_dir)
    zoo = {"citeseer": dt.data.CiteseerGraphDataset,
           "pubmed": dt.data.PubmedGraphDataset}[name](
        raw_dir=str(tmp_path / "zoo_torch"), device="cpu")
    g = zoo[0]
    assert ds.meta["num_classes"] == zoo.num_classes
    src, dst = ds.graph.edges()
    gsrc, gdst = g.edges()
    assert torch.equal(src, gsrc) and torch.equal(dst, gdst)
    (task,) = ds.tasks
    for split, mask in ((task.train_set, "train_mask"),
                        (task.validation_set, "val_mask"),
                        (task.test_set, "test_mask")):
        ids, labels = split[np.arange(len(split))]
        want = torch.nonzero(g.ndata[mask]).squeeze(1)
        assert torch.equal(torch.as_tensor(np_of(ids)), want)
        assert torch.equal(torch.as_tensor(np_of(labels)),
                           g.ndata["label"][want])
    ids = np.arange(0, g.num_nodes(), 5)
    assert torch.equal(torch.as_tensor(np_of(
        ds.feature.read("node", "_N", "feat", ids))), g.ndata["feat"][ids])


def test_builtin_dataset_loads_a_prepared_directory(tmp_path):
    """The reference materialises Cora; the port loads its directory."""
    ref = jgb.BuiltinDataset("cora", root=str(tmp_path))
    ds = tgb.BuiltinDataset("cora", root=str(tmp_path), device="cpu")
    assert isinstance(ds, tgb.Dataset) and ds.dataset_name == "cora"
    (rt,), (tt,) = ref.tasks, ds.tasks
    assert isinstance(tt, tgb.Task) and tt.metadata == rt.metadata
    exact(tt.train_set[np.arange(len(tt.train_set))],
          rt.train_set[np.arange(len(rt.train_set))])
    exact(ds.graph.edges(), ref.graph.edges())
    assert len(ds.all_nodes_set) == len(ref.all_nodes_set)
    ids = np.arange(0, ds.graph.num_nodes(), 7)
    exact(ds.feature.read("node", "_N", "feat", ids),
          ref.feature.read("node", "_N", "feat", ids))


# ---------------------------------------------------------------------------
# the host library's batched pread
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def npy(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("gb") / "feat.npy")
    arr = np.random.default_rng(0).normal(size=(5000, 24)).astype(np.float32)
    np.save(path, arr)
    return path, arr


def test_batched_pread_matches_reference(npy):
    path, arr = npy
    ids = np.random.default_rng(1).integers(0, arr.shape[0], 3000)
    row = arr.shape[1] * 4
    offset0 = np.load(path, mmap_mode="r").offset
    fd = os.open(path, os.O_RDONLY)
    try:
        got = np.zeros(ids.shape[0] * row, np.uint8)
        ref = np.zeros(ids.shape[0] * row, np.uint8)
        n_got = _host.batched_pread(fd, offset0, ids, row, got)
        n_ref = _native.batched_pread(fd, offset0, ids, row, ref)
        assert n_got == n_ref == ids.shape[0]
        assert np.array_equal(got, ref)
        assert np.array_equal(got.view(np.float32).reshape(-1, 24), arr[ids])
        # ids past the file, a short or read-only buffer: raise
        with pytest.raises(ValueError, match="out of range"):
            _host.batched_pread(fd, offset0, np.array([arr.shape[0]]), row,
                                got)
        with pytest.raises(ValueError, match="out of range"):
            _host.batched_pread(fd, offset0, np.array([-1]), row, got)
        with pytest.raises(ValueError, match="holds"):
            _host.batched_pread(fd, offset0, ids, row, got[:row])
        ro = got.copy()
        ro.flags.writeable = False
        with pytest.raises(ValueError, match="writeable"):
            _host.batched_pread(fd, offset0, ids[:1], row, ro)
    finally:
        os.close(fd)


def test_disk_feature_pread_and_mmap(npy):
    """``test_disk_feature`` and ``test_pread_matches_mmap``: both read
    paths equal the reference's rows; pread is the default."""
    path, arr = npy
    ids = np.random.default_rng(2).integers(0, arr.shape[0], 4096)
    ref = jgb.DiskBasedFeature(path, io="pread")
    for io in (None, "pread", "mmap"):
        f = tgb.DiskBasedFeature(path, io=io)
        assert f._io == (io or "pread")
        exact(f.read(ids), ref.read(ids))
        exact(f.read([3, 7]), arr[[3, 7]])
        exact(f.read(), arr)
        assert f.size() == ref.size() == (24,)
        assert f.count() == ref.count() == arr.shape[0]
        f.close()
    with pytest.raises(dt.DGLError):
        tgb.DiskBasedFeature(path, io="uring")


@pytest.mark.parametrize("ids", [
    np.array([3, 7]),                              # sparse: a pread a row
    np.arange(5000)[::-1],                         # dense, the short block
    np.concatenate([np.arange(4700, 5000), np.zeros(50, np.int64)]),
    np.random.default_rng(4).integers(0, 4774, 3000),  # dense, whole blocks
    np.zeros(0, np.int64),
], ids=["sparse", "all_reversed", "tail_and_zeros", "whole_blocks", "empty"])
def test_disk_feature_reads_rows_or_blocks(npy, ids):
    """The pread path reads a row at a time or, where the rows lie dense,
    whole blocks of the file; the rows are the reference's either way, in
    the order asked, the file's short last block included."""
    path, arr = npy
    f = tgb.DiskBasedFeature(path)
    per = tgb.feature_store._BLOCK_BYTES // f._row_bytes
    blocks = np.unique(ids[ids < arr.shape[0] // per * per] // per).size
    dense = blocks * per <= tgb.feature_store._DENSE * ids.size
    assert dense == (ids.size != 2)  # only the sparse case reads by rows
    exact(f.read(ids), jgb.DiskBasedFeature(path, io="pread").read(ids))
    for bad in ([arr.shape[0]], [-1]):
        with pytest.raises(ValueError, match="out of range"):
            f.read(np.concatenate([ids, bad]))
    f.close()


def test_disk_feature_read_async_matches(npy):
    """``test_read_async_overlaps_and_matches``."""
    path, arr = npy
    f = tgb.DiskBasedFeature(path)
    rng = np.random.default_rng(2)
    batches = [rng.integers(0, arr.shape[0], 1024) for _ in range(8)]
    futs = [f.read_async(b) for b in batches]
    for b, fut in zip(batches, futs):
        exact(fut.result(), arr[b])
    f.close()


def _rss_mb():
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS"):
                return int(line.split()[1]) / 1024
    return 0.0


@pytest.mark.slow
def test_epoch_rss_bounded(tmp_path):
    """``test_epoch_rss_bounded`` on the port's pread path: an epoch over a
    1.6 GB table grows the resident memory far less than the table."""
    path = tmp_path / "big.npy"
    rows, F = 1_600_000, 256
    chunk = np.zeros((100_000, F), np.float32)
    with open(path, "wb") as fh:
        np.lib.format.write_array_header_2_0(
            fh, {"descr": "<f4", "fortran_order": False,
                 "shape": (rows, F)})
        for i in range(rows // chunk.shape[0]):
            chunk[:, 0] = i
            chunk.tofile(fh)
    f = tgb.DiskBasedFeature(str(path))
    rss0 = _rss_mb()
    rng = np.random.default_rng(3)
    for _ in range(64):
        ids = rng.integers(0, rows, 8192)
        out = f.read(ids)
        np.testing.assert_array_equal(
            out[:, 0], (ids // 100_000).astype(np.float32))
    growth = _rss_mb() - rss0
    f.close()
    assert growth < 400, f"RSS grew {growth:.0f} MB on a 1.6 GB table"


# ---------------------------------------------------------------------------
# item sets and samplers
# ---------------------------------------------------------------------------


def _batches(sampler):
    out = []
    for mb in sampler:
        out.append({k: np_of(getattr(mb, k)) for k in ("seeds", "labels",
                                                       "indexes")
                    if getattr(mb, k) is not None})
    return out


def test_itemset_and_item_sampler():
    for m in (jgb, tgb):
        s = m.ItemSet(np.arange(10), names="seeds")
        assert len(s) == 10 and s[3] == 3 and s.names == ("seeds",)
    items = (np.arange(25), np.arange(25) % 3)
    got = [_batches(tgb.ItemSampler(tgb.ItemSet(items, names=(
        "seeds", "labels")), batch_size=10, shuffle=True, seed=0, **kw))
        for kw in ({}, {"drop_last": True})]
    ref = [_batches(jgb.ItemSampler(jgb.ItemSet(items, names=(
        "seeds", "labels")), batch_size=10, shuffle=True, seed=0, **kw))
        for kw in ({}, {"drop_last": True})]
    exact(got, ref)
    assert len(tgb.ItemSampler(tgb.ItemSet(items), 10)) == 3
    # a torch tensor goes in as its host array
    t = tgb.ItemSet(torch.arange(6), names="seeds")
    exact(t[np.array([1, 4])], np.array([1, 4]))
    his = [m.HeteroItemSet({"a": m.ItemSet(np.arange(3), "seeds")})
           for m in (tgb, jgb)]
    assert len(his[0]) == len(his[1]) == 3
    isd = tgb.ItemSetDict({"a": tgb.ItemSet(np.arange(4), "seeds")})
    assert list(isd.keys()) == ["a"] and len(isd["a"]) == 4


@pytest.mark.parametrize("kw", [
    dict(batch_size=2, drop_uneven_inputs=True),
    dict(batch_size=3, shuffle=True),
    dict(batch_size=4, shuffle=True, drop_last=True),
])
def test_distributed_item_sampler(kw):
    items = np.arange(11)
    for r in range(2):
        got = tgb.DistributedItemSampler(tgb.ItemSet(items, "seeds"),
                                         rank=r, world_size=2, **kw)
        ref = jgb.DistributedItemSampler(jgb.ItemSet(items, "seeds"),
                                         rank=r, world_size=2, **kw)
        assert len(got) == len(ref)
        for _ in range(2):  # two epochs reshuffle alike
            exact(_batches(got), _batches(ref))


def test_distributed_item_sampler_rank_from_torch_distributed():
    """Without a process group the port is rank 0 of 1, as one JAX
    process is."""
    s = tgb.DistributedItemSampler(tgb.ItemSet(np.arange(5), "seeds"), 2)
    assert (s.rank, s.world_size) == (0, 1)
    exact(_batches(s), _batches(jgb.DistributedItemSampler(
        jgb.ItemSet(np.arange(5), "seeds"), 2)))


def test_minibatcher_default_and_minibatch():
    for m in (tgb, jgb):
        mb = m.minibatcher_default(np.arange(4), ("seeds",))
        np.testing.assert_array_equal(mb.seeds, np.arange(4))
        mb2 = m.minibatcher_default((np.arange(4), np.ones(4)),
                                    ("seeds", "labels"))
        np.testing.assert_array_equal(mb2.labels, np.ones(4))
        with pytest.raises(AttributeError):
            m.minibatcher_default((np.arange(2),) * 2, ("seeds", "bogus"))
    mb = tgb.MiniBatch(seeds=np.arange(3), labels=np.zeros(3))
    assert repr(mb) == repr(jgb.MiniBatch(seeds=np.arange(3),
                                          labels=np.zeros(3)))
    assert mb.num_seeds() == 3


# ---------------------------------------------------------------------------
# feature stores and caches
# ---------------------------------------------------------------------------


def _skewed_ids(seed=0):
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(100, 4)).astype(np.float32)
    ids = np.concatenate([rng.integers(0, 8, 400), rng.integers(0, 100, 100)])
    rng.shuffle(ids)
    return base, ids


@pytest.mark.parametrize("policy", ["lru", "clock", "sieve", "s3-fifo"])
def test_cache_policies(policy):
    """The same reads through the same policy: the same rows, hits, misses
    and slot maps as the reference's."""
    base, ids = _skewed_ids()
    got = tgb.CachedFeature(tgb.NumpyFeature(base), 16, policy=policy)
    ref = jgb.CachedFeature(jgb.NumpyFeature(base), 16, policy=policy)
    for chunk in np.array_split(ids, 5):
        exact(got.read(chunk), ref.read(chunk))
    assert (got.hits, got.misses) == (ref.hits, ref.misses)
    assert got._policy.key_to_slot == ref._policy.key_to_slot
    exact(got._buf, ref._buf)
    assert got.hit_rate == ref.hit_rate > 0.3
    pol = {"lru": tgb.LRUPolicy, "clock": tgb.ClockPolicy,
           "sieve": tgb.SievePolicy, "s3-fifo": tgb.S3FifoPolicy}[policy]
    assert tgb.cache_policies[policy] is pol
    assert isinstance(got._policy, tgb.CachePolicy)
    with pytest.raises(dt.DGLError):
        tgb.CachedFeature(tgb.NumpyFeature(base), 4, policy="fifo")


def test_feature_store_and_numpy_feature():
    arr = np.arange(30.0).reshape(10, 3)
    got = tgb.FeatureStore({("node", "_N", "feat"): arr})
    ref = jgb.FeatureStore({("node", "_N", "feat"): arr})
    exact(got.read("node", "_N", "feat", [0, 2]),
          ref.read("node", "_N", "feat", [0, 2]))
    assert got.size("node", "_N", "feat") == (3,)
    assert ("node", "_N", "feat") in got and list(got.keys()) == list(
        ref.keys())
    f = tgb.NumpyFeature(arr.copy())
    f.update(np.ones((2, 3)), np.array([1, 4]))
    g = jgb.NumpyFeature(arr.copy())
    g.update(np.ones((2, 3)), np.array([1, 4]))
    exact(f.read(), g.read())
    assert isinstance(f, tgb.Feature) and f.count() == 10
    with pytest.raises(NotImplementedError):
        tgb.Feature().read()
    got[("node", "_N", "x")] = tgb.NumpyFeature(arr)
    assert isinstance(got[("node", "_N", "x")], tgb.Feature)


def test_torch_based_feature_stores(tmp_path):
    t = torch.arange(12, dtype=torch.float32).reshape(6, 2)
    got, ref = tgb.TorchBasedFeature(t.clone()), jgb.TorchBasedFeature(
        t.clone())
    exact(got.read(np.array([1, 3])), ref.read(np.array([1, 3])))
    assert got.size() == ref.size() and got.count() == ref.count()
    for f in (got, ref):
        f.update(torch.zeros(1, 2), np.array([0]))
    exact(got.read(), ref.read())
    assert got.metadata() == {}
    specs = [{"domain": "node", "type": "_N", "name": "x", "tensor": t}]
    p = str(tmp_path / "f.npy")
    np.save(p, np.ones((4, 2), np.float32))
    stores = [m.TorchBasedFeatureStore(specs + [m.OnDiskFeatureData(
        domain=m.OnDiskFeatureDataDomain.NODE, name="feat", path=p,
        type=None)]) for m in (tgb, jgb)]
    for key in (("node", "_N", "x"), ("node", "_N", "feat")):
        exact(stores[0].read(*key, np.array([1])),
              stores[1].read(*key, np.array([1])))
    keys = tgb.get_feature_key_list(stores[0])
    assert keys == [tuple(k) for k in jgb.get_feature_key_list(stores[1])]
    assert keys[0] == tgb.FeatureKey("node", "_N", "x")
    basic = tgb.BasicFeatureStore({("node", "_N", "y"): np.arange(4.0)[:, None]})
    exact(basic.read("node", "_N", "y", np.array([2])), [[2.0]])


def test_cpu_cached_feature():
    base = np.arange(40.0).reshape(10, 4)
    ids = np.array([1, 2, 1, 3, 1, 7, 2, 9])
    got = tgb.cpu_cached_feature(tgb.NumpyFeature(base), 4 * 8 * 3)
    ref = jgb.cpu_cached_feature(jgb.NumpyFeature(base), 4 * 8 * 3)
    for _ in range(2):
        exact(got.read(ids), ref.read(ids))
    assert (got.cache.hits, got.cache.misses) == (ref.cache.hits,
                                                  ref.cache.misses)
    assert got.hit_rate == ref.hit_rate > 0
    exact(got.cache._buf, ref.cache._buf)
    # one cache shared by two features through id offsets
    cache = tgb.CPUFeatureCache((4, 4), np.float64)
    f1 = tgb.CPUCachedFeature(tgb.NumpyFeature(base), cache, offset=0)
    f2 = tgb.CPUCachedFeature(tgb.NumpyFeature(base * 2), cache, offset=100)
    exact(f1.read(np.array([0])), [[0, 1, 2, 3]])
    exact(f2.read(np.array([0])), [[0, 2, 4, 6]])
    assert set(cache._policy.key_to_slot) == {0, 100}
    assert isinstance(tgb.wrap_with_cached_feature(
        {"a": tgb.NumpyFeature(base)}, max_cache_size_in_bytes=64)["a"],
        tgb.CPUCachedFeature)


def test_device_cached_feature_on_cpu():
    """``gpu_cached_feature`` with the table asked on the CPU: the rows,
    hits and misses of the reference's device cache."""
    base = np.arange(20.0).reshape(10, 2)
    got = tgb.gpu_cached_feature(tgb.NumpyFeature(base), 2 * 8 * 5,
                                 device="cpu")
    ref = jgb.gpu_cached_feature(jgb.NumpyFeature(base), 2 * 8 * 5)
    assert isinstance(got, tgb.GPUCachedFeature)
    assert tgb.DeviceCachedFeature is tgb.GPUCachedFeature
    for ids in (np.array([0, 4, 9, 2]), np.array([9, 8]), np.array([1, 1])):
        exact(got.read(ids), ref.read(ids))
    assert (got.hits, got.misses) == (ref.hits, ref.misses) == (5, 3)
    assert got.hit_rate == ref.hit_rate
    exact(got.read(), ref.read())
    assert got._cache.table.device.type == "cpu"
    exact(got._cache.slots_of(np.array([0, 4, 7, 99])), [0, 4, -1, -1])
    cache = tgb.GPUFeatureCache(np.array([3, 5]), base[[3, 5]], device="cpu")
    f = tgb.DeviceCachedFeature(tgb.NumpyFeature(base), cache)
    exact(f.read(np.array([5, 0, 3])), base[[5, 0, 3]])
    assert f.size() == (2,) and f.count() == 10


def _hbm_pair(hot_ids, n=200, f=8, seed=0):
    arr = np.random.default_rng(seed).normal(size=(n, f)).astype(np.float32)
    return (tgb.HBMFeatureCache(tgb.NumpyFeature(arr), hot_ids, device="cpu"),
            jgb.HBMFeatureCache(jgb.NumpyFeature(arr), hot_ids), arr)


@pytest.mark.parametrize("hot,batches", [
    (np.arange(0, 200, 3), [np.random.default_rng(1).integers(0, 200, 64)]),
    (np.arange(100), [np.arange(50), np.arange(150, 200)]),
    (np.asarray([0]), [np.asarray([1, 2, 3]), np.asarray([0, 0])]),
    (np.arange(10), [np.array([0, 0, 0, 5, 199, 0])]),
], ids=["every_third", "hit_then_miss", "all_miss_all_hit", "padding_zeros"])
def test_hbm_feature_cache(hot, batches):
    """``test_hbm_cache.py``'s cases: the rows, the split (through
    ``searchsorted``, padding id 0 included) and the counts."""
    got, ref, arr = _hbm_pair(hot)
    for ids in batches:
        exact(got.split(ids), ref.split(ids))
        out = got.read(ids)
        exact(out, ref.read_batch(ids))
        exact(out, arr[ids])
    assert (got.hits, got.misses) == (ref.hits, ref.misses)
    assert got.hit_rate() == ref.hit_rate()
    assert got.capacity == ref.capacity
    assert got.size() == (8,) and got.count() == 200
    exact(got.read(), ref.read())


def test_hbm_cache_from_degrees():
    arr = np.random.default_rng(0).normal(size=(200, 8)).astype(np.float32)
    deg = np.zeros(200)
    deg[[5, 17, 99]] = [10, 30, 20]
    got = tgb.HBMFeatureCache.from_degrees(tgb.NumpyFeature(arr), deg, 3,
                                           device="cpu")
    ref = jgb.HBMFeatureCache.from_degrees(jgb.NumpyFeature(arr), deg, 3)
    exact(got._hot_sorted, ref._hot_sorted)
    exact(got.read_batch(np.asarray([17, 99, 5])), arr[[17, 99, 5]])
    assert got.misses == 0 and isinstance(got, tgb.Feature)


def test_parquet_feature(tmp_path):
    arr = np.random.default_rng(0).normal(size=(20, 6)).astype(np.float32)
    for m, d in ((tgb, "t"), (jgb, "j")):
        os.makedirs(tmp_path / d)
        m.ParquetFeature.write(str(tmp_path / d / "f.parquet"), arr)
        m.ParquetFeature.write(str(tmp_path / d / "l.parquet"), np.arange(20))
        m.save_data(arr, str(tmp_path / d / "x.parquet"), "parquet")
    got = tgb.ParquetFeature(str(tmp_path / "t" / "f.parquet"))
    ref = jgb.ParquetFeature(str(tmp_path / "j" / "f.parquet"))
    assert got.count() == 20 and got.size() == ref.size() == (6,)
    exact(got.read(np.array([3, 7, 3])), ref.read(np.array([3, 7, 3])))
    exact(got.read(), ref.read())
    lab = tgb.ParquetFeature(str(tmp_path / "t" / "l.parquet"))
    assert lab.read(np.array([5]))[0] == 5 and lab.size() == ()
    exact(tgb.read_data(str(tmp_path / "t" / "x.parquet"), "parquet"),
          jgb.read_data(str(tmp_path / "j" / "x.parquet"), "parquet"))
    import pyarrow as pa
    import pyarrow.parquet as pq

    pq.write_table(pa.table({"src": np.array([0, 1]),
                             "dst": np.array([2, 3])}),
                   str(tmp_path / "e.parquet"))
    exact(tgb.read_edges(str(tmp_path), "parquet", "e.parquet"),
          jgb.read_edges(str(tmp_path), "parquet", "e.parquet"))


# ---------------------------------------------------------------------------
# the on-disk dataset, its metadata and files
# ---------------------------------------------------------------------------


def _toy_dataset(m, path, **kw):
    rng = np.random.default_rng(0)
    src, dst = rng.integers(0, 50, 400), rng.integers(0, 50, 400)
    feats = rng.normal(size=(50, 6)).astype(np.float32)
    labels = rng.integers(0, 3, 50)
    return m.OnDiskDataset.write(
        path, name="toy", src=src, dst=dst, num_nodes=50,
        features={"feat": feats}, labels=labels, train_ids=np.arange(30),
        test_ids=np.arange(30, 50), **kw)


def _dir_files(path):
    out = {}
    for name in sorted(os.listdir(path)):
        p = os.path.join(path, name)
        if name == "metadata.json":
            with open(p) as f:
                out[name] = json.load(f)
        elif name.endswith(".npy"):
            out[name] = np.load(p)
    return out


def test_ondisk_dataset(tmp_path):
    got = _toy_dataset(tgb, str(tmp_path / "t"), device="cpu")
    ref = _toy_dataset(jgb, str(tmp_path / "j"))
    exact(_dir_files(str(tmp_path / "t")), _dir_files(str(tmp_path / "j")))
    assert got.dataset_name == ref.dataset_name == "toy"
    assert got.graph.device.type == "cpu"
    exact(got.graph.edges(), ref.graph.edges())
    assert isinstance(got.feature[("node", "_N", "feat")],
                      tgb.DiskBasedFeature)
    exact(got.feature.read("node", "_N", "feat", [1, 2]),
          ref.feature.read("node", "_N", "feat", [1, 2]))
    for key in ("train_set", "test_set"):
        a, b = getattr(got, key), getattr(ref, key)
        assert a.names == b.names and len(a) == len(b)
        exact(a[np.arange(len(a))], b[np.arange(len(b))])
    assert got.validation_set is None
    (task,) = got.tasks
    assert isinstance(task, tgb.OnDiskTask) and task.metadata == {
        "dataset_name": "toy"}
    assert repr(task) == repr(ref.tasks[0])
    assert len(got.all_nodes_set) == 50
    again = tgb.OnDiskDataset(str(tmp_path / "t"), device="cpu")
    assert again.graph.num_edges() == 400


def test_legacy_dataset(tmp_path):
    src, dst = graph_arrays(40, 200, 3)
    feat = np.random.default_rng(4).normal(size=(40, 5)).astype(np.float32)
    mask = np.arange(40) < 25

    class Legacy:
        name = "toy"

        def __init__(self, g):
            self.g = g

        def __getitem__(self, i):
            return self.g

    tg = dt.graph((src, dst), num_nodes=40, device="cpu")
    jg = dgl_tpu.graph((src, dst), num_nodes=40)
    for g, conv in ((tg, torch.from_numpy), (jg, np.asarray)):
        g.ndata["feat"] = conv(feat)
        g.ndata["label"] = conv(np.arange(40) % 3)
        g.ndata["train_mask"] = conv(mask)
    got = tgb.LegacyDataset(Legacy(tg), root=str(tmp_path / "t"),
                            device="cpu")
    ref = jgb.LegacyDataset(Legacy(jg), root=str(tmp_path / "j"))
    exact(_dir_files(str(tmp_path / "t" / "legacy_toy")),
          _dir_files(str(tmp_path / "j" / "legacy_toy")))
    assert got.graph.num_nodes() == 40 and len(got.tasks[0].train_set) == 25


def test_ondisk_metadata_and_preprocess(tmp_path):
    meta = {
        "dataset_name": "demo",
        "graph_topology": {"type": "FusedCSCSamplingGraph", "path": "g.npz"},
        "feature_data": [{"domain": "node", "name": "feat",
                          "format": "numpy", "path": "feat.npy",
                          "in_memory": False}],
        "tasks": [{"name": "nc", "num_classes": 3, "custom": 1,
                   "train_set": [{"type": None, "data": [
                       {"format": "numpy", "path": "train.npy"}]}]}],
    }
    got, ref = (m.OnDiskMetaData.from_dict(meta) for m in (tgb, jgb))
    assert got.dataset_name == ref.dataset_name == "demo"
    assert got.graph_topology.type == \
        tgb.OnDiskGraphTopologyType.FUSED_CSC_SAMPLING
    assert got.graph_topology.type.value == ref.graph_topology.type.value
    assert isinstance(got.graph_topology, tgb.OnDiskGraphTopology)
    assert got.feature_data[0].domain == tgb.OnDiskFeatureDataDomain.NODE
    assert got.feature_data[0].format == tgb.OnDiskFeatureDataFormat.NUMPY
    assert isinstance(got.feature_data[0], tgb.OnDiskFeatureData)
    (t,), (r,) = got.tasks, ref.tasks
    assert isinstance(t, tgb.OnDiskTaskData)
    assert (t.name, t.num_classes, t.extra_fields) == (
        r.name, r.num_classes, r.extra_fields)
    assert isinstance(t.train_set[0], tgb.OnDiskTVTSet)
    assert isinstance(t.train_set[0].data[0], tgb.OnDiskTVTSetData)
    assert t.train_set[0].data[0].path == r.train_set[0].data[0].path
    assert t.validation_set == []
    assert tgb.ExtraMetaData(a=1).extra_fields == {"a": 1}
    for m, d, kw in ((tgb, "t", {"device": "cpu"}), (jgb, "j", {})):
        m.OnDiskDataset.write(
            str(tmp_path / d), name="demo", src=np.array([0, 1]),
            dst=np.array([1, 0]), num_nodes=2,
            features={"feat": np.eye(2, dtype=np.float32)}, **kw)
        p = m.preprocess_ondisk_dataset(str(tmp_path / d))
        assert p.endswith("metadata.json")
        assert not m.check_dataset_change(str(tmp_path / d), "preprocessed")
    exact(json.load(open(tmp_path / "t" / "preprocessed" /
                         "dataset_hash.json")),
          json.load(open(tmp_path / "j" / "preprocessed" /
                         "dataset_hash.json")))
    np.save(tmp_path / "t" / "src.npy", np.array([1, 1]))
    assert tgb.check_dataset_change(str(tmp_path / "t"), "preprocessed")
    with pytest.raises(dt.DGLError):
        tgb.preprocess_ondisk_dataset(str(tmp_path / "missing"))
    with pytest.raises(dt.DGLError):
        tgb.OnDiskDataset(str(tmp_path / "missing"), device="cpu")


def test_io_utils(tmp_path):
    arr = np.arange(12.0).reshape(3, 4)
    for m, d in ((tgb, "t"), (jgb, "j")):
        os.makedirs(tmp_path / d)
        m.save_data(arr, str(tmp_path / d / "a.npy"), "numpy")
        m.numpy_save_aligned(str(tmp_path / d / "aligned"), arr)
        m.save_data(torch.arange(3), str(tmp_path / d / "t.pt"), "torch")
        np.save(tmp_path / d / "ids.npy", np.arange(5)[:, None])
        m.copy_or_convert_data(str(tmp_path / d / "ids.npy"),
                               str(tmp_path / d / "out.npy"), "numpy",
                               within_int32=True)
    for name in ("a.npy", "aligned.npy", "out.npy"):
        with open(tmp_path / "t" / name, "rb") as f, \
                open(tmp_path / "j" / name, "rb") as g:
            assert f.read() == g.read(), name
    p = str(tmp_path / "t" / "a.npy")
    exact(tgb.read_data(p, "numpy"), arr)
    exact(tgb.read_data(p, "numpy", in_memory=False), arr)
    assert tgb.get_npy_dim(p) == 2
    with open(tmp_path / "t" / "aligned.npy", "rb") as f:
        version = np.lib.format.read_magic(f)
        np.lib.format._read_array_header(f, version)
        assert f.tell() % 4096 == 0
    assert tgb.read_data(str(tmp_path / "t" / "t.pt"), "torch").tolist() == [
        0, 1, 2]
    with pytest.raises(ValueError):
        tgb.read_data(p, "hdf5")
    np.save(tmp_path / "e.npy", np.array([[0, 1], [1, 2]]))
    exact(tgb.read_edges(str(tmp_path), "numpy", "e.npy"),
          jgb.read_edges(str(tmp_path), "numpy", "e.npy"))
    assert tgb.calculate_file_hash(p) == jgb.calculate_file_hash(p)
    assert tgb.calculate_dir_hash(str(tmp_path / "t")) == \
        jgb.calculate_dir_hash(str(tmp_path / "t"))
    import hashlib

    assert tgb.check_sha1(p, hashlib.sha1(open(p, "rb").read()).hexdigest())
    zp = str(tmp_path / "z.zip")
    with zipfile.ZipFile(zp, "w") as z:
        z.write(p, "a.npy")
    tgb.extract_archive(zp, str(tmp_path / "out"))
    assert (tmp_path / "out" / "a.npy").exists()
    assert tgb.download("http://x/a.npy", path=p) == p
    with pytest.raises(RuntimeError):
        tgb.download("http://x/missing.npy", path=str(tmp_path / "nope"))


# ---------------------------------------------------------------------------
# id primitives and utilities
# ---------------------------------------------------------------------------


def test_base_index_utils():
    indptr = np.array([0, 2, 5, 7])
    cases = [
        lambda m: m.expand_indptr(indptr, dtype=np.int64),
        lambda m: m.expand_indptr(indptr, node_ids=np.array([10, 20, 30])),
        lambda m: m.indptr_edge_ids(indptr, dtype=np.int64),
        lambda m: m.indptr_edge_ids(indptr, offset=np.array([0, 100, 200])),
        lambda m: m.isin(np.array([1, 2, 3, 4]), np.array([2, 3])),
        lambda m: m.index_select(np.arange(10) * 2, np.array([1, 3])),
        lambda m: m.etype_tuple_to_str(("user", "like", "item")),
        lambda m: m.etype_str_to_tuple("user:like:item"),
        lambda m: m.seed_type_str_to_ntypes("user:like:item", 2),
        lambda m: m.seed_type_str_to_ntypes("q:u:i", 3),
        lambda m: (m.CANONICAL_ETYPE_DELIMITER, m.ORIGINAL_EDGE_ID),
    ]
    for case in cases:
        exact(case(tgb), case(jgb))


@pytest.mark.parametrize("nodes,kw", [
    ([np.array([5, 2, 5]), np.array([2, 7])], {}),
    ([np.array([0, 1, 2, 3, 4, 5])], dict(rank=1, world_size=2)),
    ([np.array([9, 3, 3, 14, 0]), np.array([7, 9])], dict(rank=2,
                                                          world_size=3)),
    ({"a": [np.array([3, 3, 1])], "b": [np.array([4]), np.array([4, 8])]},
     {}),
], ids=["homo", "rank1_of_2", "rank2_of_3", "hetero"])
def test_unique_and_compact(nodes, kw):
    exact(tgb.unique_and_compact(nodes, **kw),
          jgb.unique_and_compact(nodes, **kw))
    exact(tgb.unique_and_compact(nodes, async_op=True, **kw).wait(),
          jgb.unique_and_compact(nodes, **kw))
    cat = np.array([4, 4, 9, 1, 9, 0])
    exact(tgb.base._unique_first_occurrence_inverse(cat),
          unique_first_occurrence(cat))


def test_compact_csc_formats():
    csc = [m.CSCFormatBase(indptr=np.array([0, 1, 3]),
                           indices=np.array([7, 7, 9])) for m in (tgb, jgb)]
    dst = np.array([1, 2])

    def flat(res):
        return [(r.indptr, r.indices) if hasattr(r, "indptr") else r
                for r in res]

    exact(flat(tgb.compact_csc_format(csc[0], dst)),
          flat(jgb.compact_csc_format(csc[1], dst)))
    exact(flat(tgb.compact_csc_format(csc[0], dst, np.array([10, 20]))),
          flat(jgb.compact_csc_format(csc[1], dst, np.array([10, 20]))))
    exact(flat(tgb.unique_and_compact_csc_formats(csc[0], dst)),
          flat(jgb.unique_and_compact_csc_formats(csc[1], dst)))
    exact(tgb.compact_temporal_nodes([np.array([4, 5])], [np.array([1, 2])]),
          jgb.compact_temporal_nodes([np.array([4, 5])], [np.array([1, 2])]))
    hetero = {"user:follows:item": (np.array([0, 2]), np.array([7, 8]))}
    rows = [m.compact_csc_format(
        {k: m.CSCFormatBase(*v) for k, v in hetero.items()},
        {"item": np.array([3])}, dst_timestamps={"item": np.array([42])})
        for m in (tgb, jgb)]
    exact(rows[0][0], rows[1][0])
    exact(rows[0][2], rows[1][2])
    res = [m.unique_and_compact_csc_formats(
        {k: m.CSCFormatBase(*v) for k, v in hetero.items()},
        {"item": np.array([3])}, rank=0, world_size=2, async_op=True).wait()
        for m in (tgb, jgb)]
    exact(res[0][0], res[1][0])
    exact(res[0][2], res[1][2])
    assert repr(csc[0]) == repr(csc[1])


def test_reflection_utils():
    mb = tgb.MiniBatch(seeds=np.arange(3))
    assert tgb.get_attributes(mb) == jgb.get_attributes(
        jgb.MiniBatch(seeds=np.arange(3)))
    assert tgb.get_nonproperty_attributes(mb) == \
        jgb.get_nonproperty_attributes(jgb.MiniBatch(seeds=np.arange(3)))
    assert tgb.is_listlike([1]) and not tgb.is_listlike(np.arange(2))
    assert tgb.is_scalar(3) and tgb.is_scalar(np.float32(1.0))
    assert tgb.is_scalar(torch.tensor(2)) and not tgb.is_scalar(np.arange(2))
    moved = tgb.apply_to({"x": np.arange(3), "s": "keep",
                          "t": [torch.ones(2)]}, "cpu")
    assert isinstance(moved["x"], torch.Tensor)
    exact(moved["x"], [0, 1, 2])
    assert moved["s"] == "keep" and moved["t"][0].device.type == "cpu"
    for m in (tgb, jgb):
        out = m.recursive_apply([{"a": 1}, (2, 3)], lambda v: v * 10)
        assert out[0]["a"] == 10 and out[1] == (20, 30)
        assert m.recursive_apply_reduce_all([1, {"b": 2}], lambda v: v > 0)
        assert m.bytes_to_number_of_items(
            100, np.zeros((4, 5), np.float32)) == 5
        assert m.is_wsl() in (True, False)
    assert tgb.built_with_cuda() == (torch.version.cuda is not None)
    assert not tgb.is_object_pinned(np.zeros(2))
    assert not tgb.is_object_pinned(torch.zeros(2))
    with pytest.warns(tgb.GBWarning):
        tgb.gb_warning("x")
    assert tgb.gb_warning_format("m", tgb.GBWarning, "f", 1) == \
        jgb.gb_warning_format("m", jgb.GBWarning, "f", 1)


def test_cooperative_helpers_and_all_to_all():
    for m in (tgb, jgb):
        assert m.count_split(10, 3, 0) == 4 and m.count_split(10, 3, 2) == 3
        assert m.calculate_range(10, 3, 1) == (4, 7)
        assert m.revert_to_homo({"_N": 5}) == 5
        assert m.revert_to_homo({"a": 5, "b": 6}) == {"a": 5, "b": 6}
        assert m.convert_to_hetero(5) == {"_N": 5}
    outs = [np.zeros(2), torch.zeros(2)]
    tgb.all_to_all(outs, [np.ones(2), 2 * torch.ones(2)])
    exact(outs, [[1, 1], [2, 2]])
    assert tgb.all_to_all(outs, [np.ones(2)] * 2, async_op=True).wait() \
        is None
    ro = np.zeros(2)
    ro.flags.writeable = False
    with pytest.raises(TypeError):
        tgb.all_to_all([ro], [np.ones(2)])
    assert tgb.get_host_to_device_uva_stream() is None
    assert tgb.get_device_to_host_uva_stream() is None


_ALL_TO_ALL = """
import sys
import numpy as np
import torch.distributed as dist
rank, world, port = map(int, sys.argv[1:])
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                        world_size=world, rank=rank)
from dgl_tpu_torch import graphbolt as gb
outputs = [np.zeros(3, np.int64) for _ in range(world)]
gb.all_to_all(outputs, [np.full(3, 10 * rank + j, np.int64)
                        for j in range(world)])
dist.destroy_process_group()
print([o.tolist() for o in outputs])
"""


def test_all_to_all_over_gloo():
    """Two processes over gloo: ``outputs[j]`` holds what process ``j``
    sent to this one, as ``torch.distributed.all_to_all`` gives it."""
    import socket
    import subprocess
    import sys

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = [subprocess.Popen(
        [sys.executable, "-c", _ALL_TO_ALL, str(r), "2", str(port)],
        cwd=root, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    for rank, p in enumerate(procs):
        out, err = p.communicate(timeout=120)
        assert p.returncode == 0, err[-2000:]
        assert out.strip().splitlines()[-1] == str(
            [[10 * j + rank] * 3 for j in range(2)])


# ---------------------------------------------------------------------------
# the loader and the datapipe utilities
# ---------------------------------------------------------------------------


def _loader_batches(m, g, feats, **loader_kw):
    kw = {"device": "cpu"} if m is tgb else {}
    dp = m.ItemSampler(m.ItemSet(np.arange(60), names="seeds"),
                       batch_size=16, shuffle=True, seed=0)
    dp = m.NeighborSamplerStage(dp, g, [3, 3], batch_size=16, seed=0, **kw)
    dp = m.FeatureFetcher(dp, m.FeatureStore({("node", "_N", "feat"): feats}),
                          ["feat"])
    dp = m.CopyTo(dp, **kw)
    return [(mb.seeds, mb.input_nodes, mb.node_features["feat"], mb.blocks)
            for mb in m.DataLoader(dp, **loader_kw)]


@pytest.mark.parametrize("loader_kw", [
    dict(use_prefetch_thread=False),
    dict(use_prefetch_thread=True, overlap_copy=True),
    dict(use_prefetch_thread=True, overlap_copy=False, num_prefetch=1),
], ids=["inline", "overlap_copy", "thread"])
def test_dataloader_full_pipeline(graphs, loader_kw):
    """``test_full_pipeline`` and
    ``test_dataloader_overlap_copy_preserves_batches``: every way of
    running the loader gives the reference's inline batches: seeds, input
    ids, features and blocks."""
    from test_torch_graph_utils import same_graph

    jg, tg = graphs
    feats = np.random.default_rng(1).normal(size=(100, 8)).astype(np.float32)
    ref = _loader_batches(jgb, jg, feats, use_prefetch_thread=False)
    got = _loader_batches(tgb, tg, feats, **loader_kw)
    assert len(got) == len(ref) == 4
    for (s, i, f, b), (rs, ri, rf, rb) in zip(got, ref):
        assert isinstance(s, torch.Tensor) and isinstance(f, torch.Tensor)
        exact(s, rs)
        exact(i, ri)
        exact(f, rf)
        assert f.shape[0] == i.shape[0]
        assert len(b) == 2
        for tb, jb in zip(b, rb):
            same_graph(tb, jb, "block", batch=False)
    assert len(tgb.DataLoader(tgb.ItemSampler(tgb.ItemSet(np.arange(60)),
                                              16))) == 4


def test_recipe_from_disk_through_the_card_cache(tmp_path):
    """The GraphBolt node-classification recipe from a written dataset:
    ``DiskBasedFeature`` (pread) behind ``HBMFeatureCache.from_degrees``,
    the loader's thread, on both sides: the batches (padding rows
    included, through the cache's ``searchsorted``), hits and misses."""
    from test_torch_graph_utils import same_graph

    rng = np.random.default_rng(5)
    src, dst = graph_arrays(300, 3000, 6)
    feats = rng.normal(size=(300, 12)).astype(np.float32)
    labels = rng.integers(0, 5, 300)
    out = []
    for m, d, kw in ((tgb, "t", {"device": "cpu"}), (jgb, "j", {})):
        ds = m.OnDiskDataset.write(
            str(tmp_path / d), name="toy", src=src, dst=dst, num_nodes=300,
            features={"feat": feats}, labels=labels,
            train_ids=np.arange(0, 300, 3), **kw)
        deg = np.bincount(dst, minlength=300)
        cache = m.HBMFeatureCache.from_degrees(
            ds.feature[("node", "_N", "feat")], deg, 30, **kw)
        dp = m.ItemSampler(ds.train_set, 32, shuffle=True, seed=0)
        dp = m.NeighborSamplerStage(dp, ds.graph, [4, 4], batch_size=32,
                                    seed=0, **kw)
        key = ("node", "_N", "feat")
        if m is tgb:
            store = tgb.FeatureStore({key: cache})
            assert store[key] is cache
        else:  # the reference's store wraps a cache, which is no Feature
            store = jgb.FeatureStore()
            store._features[key] = cache
        dp = m.CopyTo(m.FeatureFetcher(dp, store, ["feat"]), **kw)
        loader = (m.DataLoader(dp, overlap_copy=True) if m is tgb
                  else m.DataLoader(dp, use_prefetch_thread=False))
        out.append(([(mb.seeds, mb.labels, mb.input_nodes,
                       mb.node_features["feat"], mb.blocks)
                      for mb in loader], cache.hits, cache.misses))
    (got, gh, gm), (ref, rh, rm) = out
    assert (gh, gm) == (rh, rm) and gh > 0 and gm > 0
    assert len(got) == len(ref) == 4
    for a, b in zip(got, ref):
        exact(a[:4], b[:4])
        for tb, jb in zip(a[4], b[4]):
            same_graph(tb, jb, "block", batch=False)


def test_dataloader_surfaces_a_stage_error():
    def boom(mb):
        raise KeyError("stage failed")

    dp = tgb.MiniBatchTransformer(tgb.ItemSampler(tgb.ItemSet(np.arange(4)),
                                                  2), boom)
    with pytest.raises(KeyError, match="stage failed"):
        list(tgb.DataLoader(dp))


def test_copy_to_cpu_and_default():
    mb = tgb.MiniBatch(seeds=np.arange(3), labels=np.ones(3),
                       node_features={"x": np.zeros((3, 2))})
    out = tgb.CopyTo([mb], "cpu")._apply(mb)
    assert all(isinstance(v, torch.Tensor)
               for v in (out.seeds, out.labels, out.node_features["x"]))
    assert tgb.CopyTo([], None).device == torch.device("cuda")


def test_datapipe_graph_utils(graphs):
    jg, tg = graphs
    fused = tgb.from_dglgraph(tg)

    def chain(m, f):
        src = m.ItemSampler(m.ItemSet(np.arange(4), "seeds"), batch_size=2)
        samp = m.SamplePerLayer(src, f, fanout=2, seed=0)
        return src, samp, m.EndMarker(samp)

    src, samp, end = chain(tgb, fused)
    graph = tgb.traverse_dps(end)
    assert len(graph) == 3
    assert tgb.find_dps(graph, tgb.SamplePerLayer) == [samp]
    assert tgb.datapipe_graph_to_adjlist(graph)[id(end)] == [id(samp)]
    comp = tgb.CompactPerLayer(tgb.SamplePerLayer(src, fused, fanout=2,
                                                  seed=0))
    tgb.replace_dp(graph, samp, comp)
    assert end.source is comp
    _, _, jend = chain(jgb, jgb.from_dglgraph(jg))
    jgraph = jgb.traverse_dps(jend)
    jsrc = jgraph[id(jend)][0].source.source
    jgb.replace_dp(jgraph, jend.source, jgb.CompactPerLayer(
        jgb.SamplePerLayer(jsrc, jgb.from_dglgraph(jg), fanout=2, seed=0)))
    for a, b in zip(list(end), list(jend)):
        sa, sb = a.sampled_subgraphs[0], b.sampled_subgraphs[0]
        exact([sa.sampled_csc.indptr, sa.sampled_csc.indices,
               sa.original_row_node_ids, a.input_nodes],
              [sb.sampled_csc.indptr, sb.sampled_csc.indices,
               sb.original_row_node_ids, b.input_nodes])
    assert isinstance(tgb.FeatureFetcherStartMarker([1])._apply(5), int)
    nodes = tgb.to_nodes(end)
    assert {str(n) for n in nodes} == {str(n) for n in jgb.to_nodes(jend)}
    node = next(iter(nodes))
    assert isinstance(node, tgb.Node) and repr(node).startswith(str(node))
    dot = tgb.to_graph(end)
    text = dot if isinstance(dot, str) else dot.source
    assert "CompactPerLayer" in text


def test_bufferer_waiter_prefetcher():
    def seeds(dp):
        return np.concatenate([np.asarray(mb.seeds) for mb in dp])

    src = lambda: tgb.ItemSampler(tgb.ItemSet(np.arange(6), "seeds"), 2)
    exact(seeds(tgb.Bufferer(src(), buffer_size=2)), np.arange(6))
    exact(seeds(tgb.PrefetcherIterDataPipe(src())), np.arange(6))

    class _Fut:
        def __init__(self, v):
            self.v = v

        def wait(self):
            return self.v

    assert list(tgb.Waiter([_Fut(1), 2, _Fut(3)])) == [1, 2, 3]
    assert list(jgb.Waiter([_Fut(1), 2, _Fut(3)])) == [1, 2, 3]


def test_lazy_features(graphs):
    """``set_*_lazy_features`` mark the frames; ``FeatureFetcher`` with no
    keys fetches the marked ones; a marked graph moves devices."""
    _, tg = graphs
    g = tg.to("cpu")
    assert dt.set_node_lazy_features is tgb.lazy.set_node_lazy_features
    dt.set_node_lazy_features(g, ["feat"])
    dt.set_src_lazy_features(g, {"h": dt.LazyFeature("h")})
    dt.set_dst_lazy_features(g, ["y"])
    dt.set_edge_lazy_features(g, ["w"])
    assert isinstance(g._node_frames["_N"]["feat"], dt.LazyFeature)
    assert repr(g._node_frames["_N"]["h"]) == "LazyFeature(name='h')"
    assert "w" in g._edge_frames[("_N", "_E", "_N")]
    assert g.to("cpu")._node_frames["_N"]["feat"].name == "feat"
    feats = np.arange(200.0).reshape(100, 2)
    store = tgb.FeatureStore({("node", "_N", "feat"): feats,
                              ("node", "_N", "h"): feats,
                              ("node", "_N", "y"): feats})
    dp = tgb.FeatureFetcher(tgb.ItemSampler(tgb.ItemSet(np.arange(4),
                                                        "seeds"), 4),
                            store, graph=g)
    (mb,) = list(dp)
    assert set(mb.node_features) == {"feat", "h", "y"}
    exact(mb.node_features["feat"], feats[:4])
    with pytest.raises(ValueError):
        tgb.FeatureFetcher([], store)
