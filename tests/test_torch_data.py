"""The port's dataset zoo (``dgl_tpu_torch/data/``) against ``dgl_tpu.data``.

Every cheap dataset is built from the same seed in both packages (the
port's on the CPU) and held exactly: each graph's relation arrays (index
dtypes included), every frame, every split and the datasets' public
attributes. The one dtype that may differ is an integer frame's or
label's: int32 in the JAX package (no x64), int64 in the port (as
``F.cross_entropy`` takes labels). The stand-ins too large for this suite
(CoraFull, the Amazon and Coauthor sets, Flickr, Yelp, the larger
heterophilous and Geom-GCN sets, full-scale Reddit) are held by the
arguments they hand the generator, which is held at small sizes with the
same options.

Also: every public name of ``dgl_tpu.data`` has a counterpart; the
utilities; the cache of the citation sets read across packages both ways;
the networkx-free MiniGC topologies and karate club against networkx for
every label and every size from 4 to 40; and ``examples/gcn_cora.py``'s
GCN on Cora in both packages, its first step's loss and gradients within
rtol = 1e-4, atol = 1e-4 * max|ref| (the same f32 operations in another
order). The real-format parsers are in ``test_torch_data_parsers.py``.
"""
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import scipy.sparse as sps
import torch

import dgl_tpu
import dgl_tpu.data as J
from dgl_tpu.data import heterophilous as j_het
from dgl_tpu.data import named_extra as j_ne
from dgl_tpu.data import synthetic as j_syn
from dgl_tpu.graph import Graph as JGraph
import dgl_tpu_torch as dt
import dgl_tpu_torch.data as T
from dgl_tpu_torch.data import generators as t_gen
from dgl_tpu_torch.data import heterophilous as t_het
from dgl_tpu_torch.data import named_extra as t_ne
from dgl_tpu_torch.data import synthetic as t_syn

CPU = {"device": "cpu"}


def np_of(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def same_array(got, ref, what):
    """Equal values and shapes; the dtype equal but for an integer array,
    which may be int64 in the port where the reference has int32."""
    g, r = np_of(got), np_of(ref)
    assert g.shape == r.shape, (what, g.shape, r.shape)
    if r.dtype.kind in "iu" and g.dtype.kind in "iu":
        assert g.dtype.itemsize >= r.dtype.itemsize, (what, g.dtype, r.dtype)
    else:
        assert g.dtype == r.dtype, (what, g.dtype, r.dtype)
    assert np.array_equal(g, r), what


def same_graph(tg, jg, what="graph"):
    """Schema, counts, every relation array (dtype included), every frame
    (values exact) and, for a batch, the per-graph sizes."""
    assert tuple(tg.canonical_etypes) == tuple(jg.canonical_etypes), what
    assert tg.ntypes == jg.ntypes, what
    assert tg._num_src_nodes == jg._num_src_nodes, what
    assert tg._num_dst_nodes == jg._num_dst_nodes, what
    for cet in jg.canonical_etypes:
        tr, jr = tg._relations[cet], jg._relations[cet]
        assert tr.num_edges == jr.num_edges, (what, cet)
        for f in jr.ARRAY_FIELDS:
            a, b = np_of(getattr(tr, f)), np.asarray(getattr(jr, f))
            assert a.dtype == b.dtype, (what, cet, f, a.dtype, b.dtype)
            assert np.array_equal(a, b), (what, cet, f)
    for name in ("_node_frames", "_edge_frames"):
        got = {k: v for k, v in getattr(tg, name).items() if v}
        ref = {k: v for k, v in getattr(jg, name).items() if v}
        assert set(got) == set(ref), (what, name, set(got), set(ref))
        for k in ref:
            assert set(got[k]) == set(ref[k]), (what, name, k)
            for f in ref[k]:
                same_array(got[k][f], ref[k][f], f"{what}.{name}[{k}][{f}]")
    assert tg.batch_size == jg.batch_size, what


def same_item(got, ref, what="item"):
    """Graphs, tuples, lists, dicts, scipy matrices, arrays and scalars."""
    if isinstance(ref, JGraph):
        same_graph(got, ref, what)
    elif isinstance(ref, (tuple, list)):
        assert len(got) == len(ref), (what, len(got), len(ref))
        for i, (a, b) in enumerate(zip(got, ref)):
            same_item(a, b, f"{what}[{i}]")
    elif isinstance(ref, dict):
        assert set(got) == set(ref), what
        for k in ref:
            same_item(got[k], ref[k], f"{what}[{k!r}]")
    elif sps.issparse(ref):
        same_item(got.toarray(), ref.toarray(), what)
    elif isinstance(ref, (str, type(None))):
        assert got == ref, (what, got, ref)
    else:
        same_array(got, ref, what)


# public attributes that are not data: the source dataset of an adapter,
# parsed schema objects
_SKIP_ATTRS = {"meta"}
_PROPERTIES = ("num_classes", "num_labels", "num_tasks", "predict_category",
               "predict_ntype", "is_temporal", "name")


def same_dataset(tds, jds, what):
    assert len(tds) == len(jds), (what, len(tds), len(jds))
    for i in range(len(jds)):
        same_item(tds[i], jds[i], f"{what}[{i}]")
    for k, v in vars(jds).items():
        if k.startswith("_") or k in _SKIP_ATTRS:
            continue
        assert hasattr(tds, k), (what, k)
        same_item(getattr(tds, k), v, f"{what}.{k}")
    for p in _PROPERTIES:
        if hasattr(type(jds), p):
            same_item(getattr(tds, p), getattr(jds, p), f"{what}.{p}")


def both(make, tmp_path):
    """``make(module, raw_dir, kw)`` for the reference and the port (on the
    CPU), each with a directory of its own."""
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    jdir.mkdir(exist_ok=True)
    tdir.mkdir(exist_ok=True)
    return make(T, str(tdir), CPU), make(J, str(jdir), {})


@pytest.fixture(autouse=True)
def _download_dir(tmp_path, monkeypatch):
    """Datasets without ``raw_dir`` resolve the default directory: keep it
    in the test's own."""
    monkeypatch.setenv("DGL_TPU_DOWNLOAD_DIR", str(tmp_path / "default"))


# -- the public names ---------------------------------------------------------


def _public(mod):
    return {n for n in dir(mod) if not n.startswith("_")} - {"annotations"}


def test_every_public_name_has_a_counterpart():
    from dgl_tpu.data import utils as j_utils
    from dgl_tpu_torch.data import utils as t_utils

    assert sorted(T.__all__) == sorted(J.__all__)
    for tm, jm in ((T, J), (t_utils, j_utils), (t_ne, j_ne)):
        missing = sorted(n for n in _public(jm) - _public(tm)
                         if not isinstance(getattr(jm, n), types.ModuleType))
        assert not missing, (jm.__name__, missing)
    assert sorted(t_utils.__all__) == sorted(j_utils.__all__)
    assert sorted(t_ne.__all__) == sorted(j_ne.__all__)
    for n in J.__all__ + ["GINDataset", "KarateClub", "SBMMixture", "QM7b",
                          "QM9", "QM9Edge", "GDELT", "ICEWS18", "SST",
                          "BitcoinOTC", "DGLBuiltinDataset"]:
        assert hasattr(T, n), n
    assert T.GINDataset is T.GraphClassificationDataset
    assert T.DGLBuiltinDataset is T.DGLDataset
    assert T.RDFGraphDataset is t_ne._RDFDataset
    assert str(T.Entity("e1", "person")) == str(J.Entity("e1", "person"))
    assert T.utils.__name__ == "dgl_tpu_torch.data.utils"
    assert T.named_extra.__name__ == "dgl_tpu_torch.data.named_extra"


# -- every cheap dataset, card-free, against the reference -------------------


def _kg_small(m, d, kw):
    return m.KnowledgeGraphDataset(num_entities=300, num_rels=7,
                                   num_triples=2000, seed=3, raw_dir=d, **kw)


DATASETS = {
    "Cora": lambda m, d, kw: m.CoraGraphDataset(raw_dir=d, **kw),
    "Citeseer": lambda m, d, kw: m.CiteseerGraphDataset(raw_dir=d, **kw),
    "Pubmed": lambda m, d, kw: m.PubmedGraphDataset(raw_dir=d, **kw),
    "Cora directed": lambda m, d, kw: m.CoraGraphDataset(
        raw_dir=d, reverse_edge=False, **kw),
    "SyntheticDataset": lambda m, d, kw: m.SyntheticDataset(**kw),
    "SyntheticDataset seed 5": lambda m, d, kw: m.SyntheticDataset(
        num_nodes=300, num_edges=2000, num_classes=5, feat_dim=16, seed=5,
        **kw),
    "RedditDataset": lambda m, d, kw: m.RedditDataset(raw_dir=d, **kw),
    "PPIDataset train": lambda m, d, kw: m.PPIDataset("train", **kw),
    "PPIDataset valid": lambda m, d, kw: m.PPIDataset("valid", **kw),
    "LegacyPPIDataset": lambda m, d, kw: m.LegacyPPIDataset("test", **kw),
    "SyntheticHeteroDataset": lambda m, d, kw: m.SyntheticHeteroDataset(
        **kw),
    "KnowledgeGraphDataset": lambda m, d, kw: m.KnowledgeGraphDataset(**kw),
    "KnowledgeGraphDataset small": _kg_small,
    "GraphClassificationDataset": lambda m, d, kw: (
        m.GraphClassificationDataset(num_graphs=60, num_classes=3, **kw)),
    "GINDataset": lambda m, d, kw: m.GINDataset(**kw),
    "FraudDataset yelp": lambda m, d, kw: m.FraudDataset("yelp", **kw),
    "FraudAmazonDataset": lambda m, d, kw: m.FraudAmazonDataset(**kw),
    "FraudYelpDataset": lambda m, d, kw: m.FraudYelpDataset(**kw),
    "CornellDataset": lambda m, d, kw: m.CornellDataset(**kw),
    "TexasDataset": lambda m, d, kw: m.TexasDataset(**kw),
    "WisconsinDataset": lambda m, d, kw: m.WisconsinDataset(**kw),
    "GeomGCNDataset cornell": lambda m, d, kw: m.GeomGCNDataset(
        "cornell", **kw),
    "BAShapeDataset": lambda m, d, kw: m.BAShapeDataset(**kw),
    "TreeCycleDataset": lambda m, d, kw: m.TreeCycleDataset(**kw),
    "TreeGridDataset": lambda m, d, kw: m.TreeGridDataset(seed=4, **kw),
    "BACommunityDataset": lambda m, d, kw: m.BACommunityDataset(**kw),
    "BA2MotifDataset": lambda m, d, kw: m.BA2MotifDataset(num_graphs=80,
                                                          **kw),
    "MiniGCDataset": lambda m, d, kw: m.MiniGCDataset(160, 4, 41, seed=2,
                                                      **kw),
    "KarateClubDataset": lambda m, d, kw: m.KarateClubDataset(**kw),
    "SBMMixtureDataset": lambda m, d, kw: m.SBMMixtureDataset(
        n_graphs=3, n_nodes=80, **kw),
    "MinesweeperDataset": lambda m, d, kw: m.MinesweeperDataset(**kw),
    "TolokersDataset": lambda m, d, kw: m.HeterophilousGraphDataset(
        "tolokers", raw_dir=d, **kw),
    "FB15k237Dataset": lambda m, d, kw: m.FB15k237Dataset(**kw),
    "WN18Dataset": lambda m, d, kw: m.WN18Dataset(**kw),
    "AIFBDataset": lambda m, d, kw: m.AIFBDataset(**kw),
    "MUTAGDataset": lambda m, d, kw: m.MUTAGDataset(**kw),
    "AMDataset": lambda m, d, kw: m.AMDataset(**kw),
    "BGSDataset": lambda m, d, kw: m.BGSDataset(**kw),
    "QM7bDataset": lambda m, d, kw: m.QM7bDataset(num_graphs=120, **kw),
    "QM9Dataset": lambda m, d, kw: m.QM9Dataset(num_graphs=120, **kw),
    "QM9EdgeDataset": lambda m, d, kw: m.QM9EdgeDataset(num_graphs=120,
                                                        **kw),
    "ZINCDataset": lambda m, d, kw: m.ZINCDataset(num_graphs=120, **kw),
    "MNISTSuperPixelDataset": lambda m, d, kw: m.MNISTSuperPixelDataset(
        num_graphs=120, **kw),
    "CIFAR10SuperPixelDataset": lambda m, d, kw: (
        m.CIFAR10SuperPixelDataset(num_graphs=60, **kw)),
    "PATTERNDataset": lambda m, d, kw: m.PATTERNDataset(**kw),
    "CLUSTERDataset": lambda m, d, kw: m.CLUSTERDataset(**kw),
    "ICEWS18Dataset": lambda m, d, kw: m.ICEWS18Dataset(**kw),
    "GDELTDataset": lambda m, d, kw: m.GDELTDataset(**kw),
    "BitcoinOTCDataset": lambda m, d, kw: m.BitcoinOTCDataset(**kw),
    "SSTDataset": lambda m, d, kw: m.SSTDataset(**kw),
    "MovieLensDataset": lambda m, d, kw: m.MovieLensDataset(**kw),
    "FakeNewsDataset": lambda m, d, kw: m.FakeNewsDataset(**kw),
    "TUDataset": lambda m, d, kw: m.TUDataset(raw_dir=d, **kw),
    "LegacyTUDataset": lambda m, d, kw: m.LegacyTUDataset("PROTEINS",
                                                          raw_dir=d, **kw),
    "PeptidesFunctionalDataset": lambda m, d, kw: (
        m.PeptidesFunctionalDataset(num_graphs=80, **kw)),
    "PeptidesStructuralDataset": lambda m, d, kw: (
        m.PeptidesStructuralDataset(num_graphs=80, **kw)),
    "VOCSuperpixelsDataset": lambda m, d, kw: m.VOCSuperpixelsDataset(
        num_graphs=30, **kw),
    "COCOSuperpixelsDataset": lambda m, d, kw: m.COCOSuperpixelsDataset(
        num_graphs=20, **kw),
    "CoraBinary": lambda m, d, kw: m.named_extra.CoraBinary(num_pairs=20,
                                                            **kw),
}


@pytest.mark.parametrize("name", sorted(DATASETS))
def test_dataset_matches_reference(name, tmp_path):
    tds, jds = both(DATASETS[name], tmp_path)
    same_dataset(tds, jds, name)


def test_datasets_lie_on_the_device_they_were_given(tmp_path):
    ds = T.CoraGraphDataset(raw_dir=str(tmp_path), device="cpu")
    g = ds[0]
    assert ds.device == torch.device("cpu")
    assert g.device == torch.device("cpu")
    assert g.ndata["label"].dtype == torch.int64
    assert g.ndata["feat"].dtype == torch.float32
    assert g.ndata["train_mask"].dtype == torch.bool
    for m in (T.MiniGCDataset(16, 4, 8, device="cpu"),
              T.SyntheticHeteroDataset(device="cpu")):
        item = m[0][0] if isinstance(m[0], tuple) else m[0]
        assert item.device == torch.device("cpu")


# -- the large stand-ins: their configurations, the generator small -----------


class _Handed(Exception):
    """Raised by the recording generator with what it was handed."""


def _record(*args, **kwargs):
    kwargs.pop("device", None)
    raise _Handed(args, kwargs)


LARGE = {
    "CoraFullDataset": lambda m: m.CoraFullDataset(),
    "CoraFull": lambda m: m.named_extra.CoraFull(),
    "AmazonCoBuyComputerDataset": lambda m: m.AmazonCoBuyComputerDataset(),
    "AmazonCoBuyPhotoDataset": lambda m: m.AmazonCoBuyPhotoDataset(),
    "CoauthorCSDataset": lambda m: m.CoauthorCSDataset(),
    "CoauthorPhysicsDataset": lambda m: m.CoauthorPhysicsDataset(),
    "AmazonCoBuy computers": lambda m: m.named_extra.AmazonCoBuy(
        "computers"),
    "Coauthor physics": lambda m: m.named_extra.Coauthor("physics"),
    "GNNBenchmarkDataset photo": lambda m: m.named_extra.GNNBenchmarkDataset(
        "amazon-co-buy-photo"),
    "WikiCSDataset": lambda m: m.WikiCSDataset(),
    "FlickrDataset": lambda m: m.FlickrDataset(),
    "YelpDataset": lambda m: m.YelpDataset(),
    "ActorDataset": lambda m: m.ActorDataset(),
    "ChameleonDataset": lambda m: m.ChameleonDataset(),
    "SquirrelDataset": lambda m: m.SquirrelDataset(),
    "GeomGCNDataset squirrel": lambda m: m.named_extra.GeomGCNDataset(
        "squirrel"),
    "RedditDataset full_scale": lambda m: m.RedditDataset(full_scale=True),
    "RomanEmpireDataset": lambda m: m.RomanEmpireDataset(),
    "AmazonRatingsDataset": lambda m: m.AmazonRatingsDataset(),
    "QuestionsDataset": lambda m: m.QuestionsDataset(),
}


def _handed(mod, generator_users, make, monkeypatch):
    for user in generator_users:
        monkeypatch.setattr(user, "synthetic_classification_graph", _record)
    with pytest.raises(_Handed) as info:
        make(mod)
    return info.value.args


@pytest.mark.parametrize("name", sorted(LARGE))
def test_large_stand_in_hands_the_generator_the_reference_arguments(
        name, monkeypatch):
    got = _handed(T, (t_syn, t_het, t_ne), LARGE[name], monkeypatch)
    ref = _handed(J, (j_syn, j_het, j_ne), LARGE[name], monkeypatch)
    assert got == ref
    assert got[0][0] >= 183  # a real configuration, not a default


@pytest.mark.parametrize("options", [
    {}, {"homophily": 0.25}, {"feature_mode": "bow", "topic_mix": 0.5},
    {"feature_mode": "bow", "noise_hubs": 0.2, "words_per_doc": 9.0},
    {"num_communities": 12, "feature_mode": "bow", "topic_mass": 0.06},
    {"signal": 0.04, "noise": 0.5, "homophily": 0.81},
])
def test_generator_matches_at_small_size(options):
    args = (400, 3000, 5, 48)
    tg = T.synthetic_classification_graph(*args, seed=11, device="cpu",
                                          **options)
    jg = J.synthetic_classification_graph(*args, seed=11, **options)
    same_graph(tg, jg)


def test_hetero_generator_matches_at_other_sizes():
    nodes = {"paper": 300, "author": 200, "institution": 20, "field": 30}
    edges = {("paper", "cites", "paper"): 900,
             ("author", "writes", "paper"): 700,
             ("paper", "has_topic", "field"): 300}
    tg = T.synthetic_hetero_graph(nodes, edges, num_classes=4, feat_dim=12,
                                  seed=3, device="cpu")
    jg = J.synthetic_hetero_graph(nodes, edges, num_classes=4, feat_dim=12,
                                  seed=3)
    same_graph(tg, jg)


# -- MiniGC and the karate club without networkx -----------------------------


def _networkx_minigc(label, n):
    """The JAX package's topology (``dgl_tpu/data/generators.py``'s
    ``MiniGCDataset.process.build``), through networkx."""
    import networkx as nx

    n = max(n, 4)
    if label == 0:
        return nx.cycle_graph(n)
    if label == 1:
        return nx.star_graph(n - 1)
    if label == 2:
        return nx.wheel_graph(n - 1)
    if label == 3:
        m = max(2, n // 2)
        return nx.lollipop_graph(m, n - m)
    if label == 4:
        return nx.convert_node_labels_to_integers(
            nx.hypercube_graph(max(2, int(np.log2(n)))))
    if label == 5:
        r = max(2, int(np.sqrt(n)))
        return nx.convert_node_labels_to_integers(nx.grid_2d_graph(r, r))
    if label == 6:
        return nx.complete_graph(min(n, 20))
    return nx.circular_ladder_graph(max(2, n // 2))


@pytest.mark.parametrize("label", range(8))
def test_minigc_topologies_match_networkx(label):
    import networkx as nx

    for n in range(4, 41):
        ref = dgl_tpu.from_networkx(nx.DiGraph(_networkx_minigc(label, n)))
        src, dst, num = t_gen.minigc_topology(label, n).directed_edges()
        assert num == ref.num_nodes(), (label, n)
        jsrc, jdst = (np.asarray(a) for a in ref.edges())
        assert np.array_equal(src, jsrc) and np.array_equal(dst, jdst), (
            label, n)


def test_karate_club_matches_networkx():
    import networkx as nx

    nxg = nx.karate_club_graph()
    ref = dgl_tpu.from_networkx(nx.DiGraph(nxg))
    tg = T.KarateClubDataset(device="cpu")[0]
    jsrc, jdst = (np.asarray(a) for a in ref.edges())
    src, dst = (a.numpy() for a in tg.edges())
    assert np.array_equal(src, jsrc) and np.array_equal(dst, jdst)
    clubs = [nxg.nodes[i]["club"] for i in range(34)]
    assert tg.ndata["label"].tolist() == [int(c != "Mr. Hi") for c in clubs]


# -- the cache of the citation sets, across packages -------------------------


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_citation_cache_reads_across_packages(writer, tmp_path):
    d = str(tmp_path)
    if writer == "jax":
        first = J.CiteseerGraphDataset(raw_dir=d)
        ds = T.CiteseerGraphDataset(raw_dir=d, device="cpu")
        ref = first
    else:
        first = T.CiteseerGraphDataset(raw_dir=d, device="cpu")
        ds = J.CiteseerGraphDataset(raw_dir=d)
        ref = J.CiteseerGraphDataset(raw_dir=d, force_reload=True)
    assert os.path.exists(first._cache_file)
    assert first._cache_file.replace(os.sep + "jax", "") == (
        ds._cache_file.replace(os.sep + "jax", ""))
    if writer == "jax":
        same_graph(ds[0], ref[0], "read by the port")
        assert ds[0].ndata["label"].dtype == torch.int64
    else:
        same_graph(first[0], ds[0], "written by the port")
        same_graph(first[0], ref[0], "against a fresh reference build")


def test_citation_cache_is_served_and_reload_rebuilds(tmp_path):
    d = str(tmp_path)
    first = T.CoraGraphDataset(raw_dir=d, device="cpu")
    mtime = os.path.getmtime(first._cache_file)
    again = T.CoraGraphDataset(raw_dir=d, device="cpu")
    assert os.path.getmtime(first._cache_file) == mtime
    same_graph(again[0], first[0])
    fresh = T.CoraGraphDataset(raw_dir=d, device="cpu", force_reload=True)
    same_graph(fresh[0], first[0])


# -- utilities -----------------------------------------------------------------


def test_split_and_mask_utilities(tmp_path):
    from dgl_tpu.data import utils as ju
    from dgl_tpu_torch.data import utils as tu

    same_array(tu.idx2mask([1, 3], 5), ju.idx2mask([1, 3], 5), "idx2mask")
    m = np.array([True, False, True])
    same_array(tu.generate_mask_tensor(m, "cpu"), ju.generate_mask_tensor(m),
               "generate_mask_tensor")
    tds = [T.SyntheticDataset(num_nodes=200, num_edges=900,
                              device="cpu")[0]]
    jds = [J.SyntheticDataset(num_nodes=200, num_edges=900)[0]]
    tu.add_nodepred_split(tds, (0.5, 0.3, 0.2), seed=4)
    ju.add_nodepred_split(jds, (0.5, 0.3, 0.2), seed=4)
    same_graph(tds[0], jds[0], "add_nodepred_split")
    for prop in ("popularity", "density", "locality"):
        tu.add_node_property_split(tds, (0.3, 0.1, 0.1, 0.2, 0.3), prop,
                                   ascending=prop != "density",
                                   random_seed=2)
        ju.add_node_property_split(jds, (0.3, 0.1, 0.1, 0.2, 0.3), prop,
                                   ascending=prop != "density",
                                   random_seed=2)
        same_graph(tds[0], jds[0], prop)
    vals = np.random.default_rng(1).random(50)
    same_item(tu.mask_nodes_by_property(vals, (0.3, 0.1, 0.1, 0.2, 0.3), 3,
                                        device="cpu"),
              ju.mask_nodes_by_property(vals, (0.3, 0.1, 0.1, 0.2, 0.3), 3),
              "mask_nodes_by_property")
    sub_t = tu.Subset(T.GINDataset(device="cpu"), [3, 1, 4])
    sub_j = ju.Subset(J.GINDataset(), [3, 1, 4])
    assert len(sub_t) == 3
    for i in range(3):
        same_item(sub_t[i], sub_j[i], f"Subset[{i}]")
    for shuffle in (False, True):
        tparts = T.split_dataset(T.GINDataset(device="cpu"), shuffle=shuffle,
                                 random_state=5)
        jparts = J.split_dataset(J.GINDataset(), shuffle=shuffle,
                                 random_state=5)
        assert [len(p) for p in tparts] == [len(p) for p in jparts]
        for tp, jp in zip(tparts, jparts):
            for i in range(len(jp)):
                same_item(tp[i], jp[i], "split_dataset")


def test_graph_utilities():
    from dgl_tpu.data import utils as ju
    from dgl_tpu_torch.data import utils as tu

    g_t = T.SyntheticDataset(num_nodes=300, num_edges=1500,
                             device="cpu")[0]
    g_j = J.SyntheticDataset(num_nodes=300, num_edges=1500)[0]
    same_array(tu.negative_sample(g_t, 200, seed=6),
               ju.negative_sample(g_j, 200, seed=6), "negative_sample")
    rng = np.random.default_rng(2)
    tri = rng.integers(0, 40, (120, 3)) % [40, 5, 40]
    kw = dict(num_nodes=40, num_rels=5, train=tri[:80], valid=tri[80:100],
              test=tri[100:])
    same_graph(tu.build_knowledge_graph(**kw, device="cpu"),
               ju.build_knowledge_graph(**kw), "build_knowledge_graph")
    same_graph(tu.build_knowledge_graph(**kw, create_reverse=False,
                                        device="cpu"),
               ju.build_knowledge_graph(**kw, create_reverse=False),
               "build_knowledge_graph without reverse")
    t_adj = tu.sbm(3, 20, 8.0, 1.0, rng=np.random.RandomState(7))
    j_adj = ju.sbm(3, 20, 8.0, 1.0, rng=np.random.RandomState(7))
    same_item(t_adj, j_adj, "sbm")
    coord, feat = rng.random((12, 2)), rng.random((12, 3))
    for use_feat in (True, False):
        a_t = tu.compute_adjacency_matrix_images(coord, feat, use_feat)
        a_j = ju.compute_adjacency_matrix_images(coord, feat, use_feat)
        same_array(a_t, a_j, "adjacency")
        same_item(tu.compute_edges_list(a_t), ju.compute_edges_list(a_j),
                  "compute_edges_list")
    same_item(tu.compute_edges_list(a_t[:5, :5]),
              ju.compute_edges_list(a_j[:5, :5]), "compute_edges_list small")
    lil = sps.random(6, 6, 0.5, random_state=1, format="csr")
    same_item(tu.eliminate_self_loops(lil), ju.eliminate_self_loops(lil),
              "eliminate_self_loops")
    assert tu.sigma(np.arange(4.0)) == ju.sigma(np.arange(4.0))
    same_item(tu.tensor_dict_to_ndarray_dict({"a": torch.arange(3)}),
              ju.tensor_dict_to_ndarray_dict({"a": np.arange(3)}),
              "tensor_dict_to_ndarray_dict")


def test_file_and_name_utilities(tmp_path):
    from dgl_tpu_torch.data import utils as tu

    p = tmp_path / "f.txt"
    p.write_text("1,2\n3,4\n")
    assert np.array_equal(tu.loadtxt(str(p), ","), [[1, 2], [3, 4]])
    import hashlib

    assert tu.check_sha1(str(p), hashlib.sha1(p.read_bytes()).hexdigest())
    assert tu.is_local_path(str(p)) and not tu.is_local_path("https://x/y")
    assert tu.check_local_file_exists(str(p))
    tu.makedirs(str(tmp_path / "a" / "b"))
    assert (tmp_path / "a" / "b").is_dir()
    tu.check_pytorch()
    old = tu.deprecate_function(lambda x: x + 1, "old", "new")
    with pytest.warns(DeprecationWarning):
        assert old(1) == 2
    Old = tu.deprecate_class(T.SyntheticDataset, "OldSynthetic")
    with pytest.warns(DeprecationWarning):
        assert len(Old(num_nodes=50, num_edges=100, device="cpu")) == 1
    assert T.get_download_dir() == J.dgl_dataset.get_download_dir()
    path = str(tmp_path / "hg.npz")
    g = T.SyntheticHeteroDataset(device="cpu")[0]
    tu.save_heterographs(path, [g])
    same_graph(T.load_graphs(path, device="cpu")[0][0],
               J.load_graphs(path)[0][0], "save_heterographs")


@pytest.mark.parametrize("loader", ["load_cora", "load_citeseer",
                                    "load_pubmed", "load_data"])
def test_legacy_loaders(loader, tmp_path):
    from dgl_tpu.data import utils as ju
    from dgl_tpu_torch.data import utils as tu

    if loader == "load_data":
        tds = tu.load_data(types.SimpleNamespace(dataset="cora"),
                           device="cpu")
        jds = ju.load_data("cora")
    else:
        tds = getattr(tu, loader)(raw_dir=str(tmp_path / "t"), device="cpu")
        jds = getattr(ju, loader)(raw_dir=str(tmp_path / "j"))
    same_dataset(tds, jds, loader)


def test_yaml_free_meta_file(tmp_path):
    from dgl_tpu.data import utils as ju
    from dgl_tpu_torch.data import utils as tu

    meta = tmp_path / "meta.json"
    meta.write_text('{"dataset_name": "x", "node_data": [{"file_name": '
                    '"n.csv"}], "edge_data": [{"file_name": "e.csv", '
                    '"etype": ["a", "r", "b"]}]}')
    t, j = tu.load_yaml_with_sanity_check(str(meta)), \
        ju.load_yaml_with_sanity_check(str(meta))
    assert t.dataset_name == j.dataset_name == "x"
    assert t.edge_data[0].etype == j.edge_data[0].etype == ("a", "r", "b")
    bad = tmp_path / "bad.json"
    bad.write_text('{"version": "1"}')
    for m in (tu, ju):
        with pytest.raises(ValueError):
            m.load_yaml_with_sanity_check(str(bad))


# -- CSV datasets ---------------------------------------------------------------


def _write_csv_dir(d, hetero=False):
    rng = np.random.default_rng(8)
    n, e = 30, 90
    os.makedirs(d, exist_ok=True)
    ids = rng.permutation(n)
    with open(os.path.join(d, "nodes.csv"), "w") as f:
        f.write("node_id,label,feat,score\n")
        for i in ids:
            vec = ",".join(f"{v:.4f}" for v in rng.random(3))
            f.write(f'{i},{i % 4},"{vec}",{rng.random():.5f}\n')
    with open(os.path.join(d, "edges.csv"), "w") as f:
        f.write("src_id,dst_id,weight\n")
        for s, t in rng.integers(0, n, (e, 2)):
            f.write(f"{s},{t},{rng.random():.5f}\n")
    etype = ["user", "follows", "user"] if hetero else ["_N", "_E", "_N"]
    ntype = "user" if hetero else "_N"
    with open(os.path.join(d, "meta.json"), "w") as f:
        f.write('{"dataset_name": "csv_test", "node_data": [{"file_name": '
                f'"nodes.csv", "ntype": "{ntype}"}}], "edge_data": '
                f'[{{"file_name": "edges.csv", "etype": {etype!r}}}]}}'
                .replace("'", '"'))


@pytest.mark.parametrize("hetero", [False, True])
def test_csv_dataset_matches_reference(hetero, tmp_path):
    d = str(tmp_path / "csv")
    _write_csv_dir(d, hetero)
    tds = T.CSVDataset(d, device="cpu")
    jds = J.CSVDataset(d)
    same_dataset(tds, jds, "CSVDataset")


def test_csv_constructor_classes(tmp_path):
    from dgl_tpu.data import csv_dataset as jc
    from dgl_tpu_torch.data import csv_dataset as tc

    d = str(tmp_path / "csv")
    _write_csv_dir(d, hetero=True)
    out = []
    for m, kw in ((tc, CPU), (jc, {})):
        nodes = m.NodeData.load_from_csv(m.MetaNode("nodes.csv", "user"), d)
        edges = m.EdgeData.load_from_csv(
            m.MetaEdge("edges.csv", ["user", "follows", "user"]), d)
        out.append(m.DGLGraphConstructor.construct_graphs(nodes, edges,
                                                          **kw))
    same_item(out[0], out[1], "construct_graphs")


# -- the adapters ---------------------------------------------------------------


ADAPTERS = {
    "AsNodePredDataset": lambda m, d, kw: m.AsNodePredDataset(
        m.SyntheticDataset(num_nodes=200, num_edges=800, **kw)),
    "AsNodePredDataset keeps masks": lambda m, d, kw: m.AsNodePredDataset(
        m.CoraGraphDataset(raw_dir=d, **kw), split_ratio=(0.5, 0.2, 0.3)),
    "AsNodePredDataset fresh masks": lambda m, d, kw: m.AsNodePredDataset(
        m.KarateClubDataset(**kw)[0], split_ratio=(0.5, 0.2, 0.3), seed=3),
    "AsLinkPredDataset": lambda m, d, kw: m.AsLinkPredDataset(
        m.CoraGraphDataset(raw_dir=d, **kw), seed=2),
    "AsGraphPredDataset": lambda m, d, kw: m.AsGraphPredDataset(
        m.MiniGCDataset(40, 5, 12, **kw), seed=1),
}


@pytest.mark.parametrize("name", sorted(ADAPTERS))
def test_adapter_matches_reference(name, tmp_path):
    tds, jds = both(ADAPTERS[name], tmp_path)
    same_dataset(tds, jds, name)


# -- the slice: examples/gcn_cora.py's GCN on the port's Cora ----------------


def test_gcn_cora_first_step_matches_reference(tmp_path):
    from dgl_tpu.models import GCN as JGCN
    from dgl_tpu_torch.models import GCN

    tds = T.CoraGraphDataset(raw_dir=str(tmp_path / "t"), device="cpu")
    jds = J.CoraGraphDataset(raw_dir=str(tmp_path / "j"))
    tg = dt.add_self_loop(dt.remove_self_loop(tds[0]))
    jg = dgl_tpu.add_self_loop(dgl_tpu.remove_self_loop(jds[0]))
    same_graph(tg, jg, "the recipe's graph")
    feat = jg.ndata["feat"]
    labels = jg.ndata["label"].astype(jnp.int32)
    train = jg.ndata["train_mask"].astype(jnp.float32)
    jmodel = JGCN(feat.shape[1], 16, jds.num_classes)
    params = jmodel.init(jax.random.PRNGKey(0), jg, feat)

    def loss_fn(p):
        logits = jmodel.apply(p, jg, feat)
        ls = optax.softmax_cross_entropy_with_integer_labels(logits, labels)
        return (ls * train).sum() / train.sum()

    jloss, jgrads = jax.value_and_grad(loss_fn)(params)
    model = GCN(tg.ndata["feat"].shape[1], 16, tds.num_classes,
                device="cpu")
    model.load_state_dict(dt.from_flax_params(params))
    model.eval()  # dropout off, as the reference's deterministic apply
    mask = tg.ndata["train_mask"].float()
    ce = torch.nn.functional.cross_entropy(
        model(tg, tg.ndata["feat"]), tg.ndata["label"], reduction="none")
    loss = (ce * mask).sum() / mask.sum()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-4)
    ref = dt.from_flax_params(jax.tree_util.tree_map(np.asarray, jgrads))
    got = {k: p.grad for k, p in model.named_parameters()}
    assert set(got) == set(ref)
    for k, r in ref.items():
        r = np.asarray(r)
        scale = np.abs(r).max()
        np.testing.assert_allclose(got[k].numpy(), r, rtol=1e-4,
                                   atol=1e-4 * scale, err_msg=k)
