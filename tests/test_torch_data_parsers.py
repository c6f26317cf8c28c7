"""The port's real-format parsers (``dgl_tpu_torch/data/parsers.py``) and
the datasets' real-file branches against ``dgl_tpu.data``.

The formats are read from the small files in ``tests/fixtures/`` (TU,
QM9, knowledge graphs, RDF, MovieLens, OGB, BitcoinOTC, temporal KG,
fraud ``.mat``) or written here into ``tmp_path`` in their published
layouts (planetoid, Reddit, PPI, superpixels, SST, FakeNews, GraphSAINT,
WikiCS, Geom-GCN, SBM, LRGB, the heterophilous ``.npz``). Each parser's
output is held exactly against the reference's, and each dataset built
from the files (the port's on the CPU) exactly, graphs, frames and splits,
the only dtype allowed to differ an integer frame's (int64 in the port,
int32 in the reference). ``from_ogb`` reads the OGB layout into a graph on
``device``.
"""
import gzip
import json
import os
import pickle

import numpy as np
import pytest
import scipy.sparse as sps

import dgl_tpu.data as J
from dgl_tpu.data import parsers as jp
import dgl_tpu_torch.data as T
from dgl_tpu_torch.data import parsers as tp

from test_torch_data import CPU, same_dataset, same_graph, same_item

FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")


@pytest.fixture(autouse=True)
def _download_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("DGL_TPU_DOWNLOAD_DIR", str(tmp_path / "default"))


# -- layouts written into a directory ----------------------------------------


def write_planetoid(d, name, n_train=20, n_all=80, n_test=20, feat_dim=10,
                    classes=3, seed=0, gap=False):
    """The planetoid file set (``ind.<name>.{x,y,tx,ty,allx,ally,graph,
    test.index}``), test rows in a permuted order; with ``gap`` the test
    range has holes (Citeseer's isolated test nodes)."""
    rng = np.random.default_rng(seed)
    n = n_all + n_test + (4 if gap else 0)

    def onehot(labels):
        oh = np.zeros((labels.shape[0], classes))
        oh[np.arange(labels.shape[0]), labels] = 1
        return oh

    labels = rng.integers(0, classes, n)
    feats = sps.csr_matrix((rng.random((n, feat_dim)) < 0.2)
                           .astype(np.float32))
    test_range = np.arange(n_all, n)
    if gap:
        test_range = np.setdiff1d(test_range, test_range[[1, 5, 6, 9]])
    test_idx = rng.permutation(test_range)
    objs = {"x": feats[:n_train], "y": onehot(labels[:n_train]),
            "tx": feats[test_idx], "ty": onehot(labels[test_idx]),
            "allx": feats[:n_all], "ally": onehot(labels[:n_all]),
            "graph": {int(i): [int(v) for v in rng.integers(0, n, 3)]
                      for i in range(n)}}
    os.makedirs(d, exist_ok=True)
    for suffix, obj in objs.items():
        with open(os.path.join(d, f"ind.{name}.{suffix}"), "wb") as f:
            pickle.dump(obj, f)
    np.savetxt(os.path.join(d, f"ind.{name}.test.index"), test_idx,
               fmt="%d")


def write_reddit(d):
    rng = np.random.default_rng(1)
    n = 60
    os.makedirs(d, exist_ok=True)
    np.savez(os.path.join(d, "reddit_data.npz"),
             feature=rng.normal(size=(n, 7)),
             label=rng.integers(0, 5, n),
             node_types=rng.integers(1, 4, n))
    sps.save_npz(os.path.join(d, "reddit_graph.npz"),
                 sps.random(n, n, 0.1, random_state=2, format="csr"))


def write_ppi(d):
    rng = np.random.default_rng(0)
    n = 40
    gid = np.repeat([0, 1], [25, 15])
    links = []
    for _ in range(120):
        a, b = rng.integers(0, n, 2)
        if gid[a] == gid[b]:
            links.append({"source": int(a), "target": int(b)})
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "train_graph.json"), "w") as f:
        json.dump({"nodes": [{"id": i} for i in range(n)], "links": links},
                  f)
    np.save(os.path.join(d, "train_feats.npy"),
            rng.normal(size=(n, 50)).astype(np.float32))
    np.save(os.path.join(d, "train_labels.npy"),
            (rng.random((n, 121)) < 0.1).astype(np.float32))
    np.save(os.path.join(d, "train_graph_id.npy"), gid)


def write_superpixels(d):
    rng = np.random.default_rng(0)
    os.makedirs(os.path.join(d, "superpixels"), exist_ok=True)
    for stem, size, count in (("mnist_75sp", 28, 5), ("cifar10_150sp", 32,
                                                      3)):
        sp_data, labels = [], []
        for i in range(count):
            n = int(rng.integers(6, 40))
            channels = 1 if stem.startswith("mnist") else 3
            sp_data.append((rng.random((n, channels)).astype(np.float32),
                            (rng.random((n, 2)) * size).astype(np.float32)))
            labels.append(i % 10)
        with open(os.path.join(d, "superpixels", f"{stem}_train.pkl"),
                  "wb") as f:
            pickle.dump((np.asarray(labels), sp_data), f)


def write_sst(d):
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "vocab.txt"), "w") as f:
        f.write("the\nmovie\nrocks\nbores\n")
    with open(os.path.join(d, "train.txt"), "w") as f:
        f.write("(3 (2 (2 the) (2 movie)) (4 rocks))\n"
                "(1 (2 (2 the) (2 movie)) (0 bores))\n")


def write_fakenews(d):
    rng = np.random.default_rng(0)
    gid = np.repeat([0, 1, 2], [5, 4, 6])
    src, dst = [], []
    for g_idx in range(3):
        nodes = np.nonzero(gid == g_idx)[0]
        for i in range(1, nodes.shape[0]):
            src.append(nodes[i])
            dst.append(nodes[0])
    os.makedirs(d, exist_ok=True)
    np.savetxt(os.path.join(d, "A.txt"), np.stack([src, dst], 1), fmt="%d",
               delimiter=", ")
    np.save(os.path.join(d, "node_graph_id.npy"), gid)
    np.save(os.path.join(d, "graph_labels.npy"), np.array([0, 1, 0]))
    for k, v in (("train", 0), ("val", 1), ("test", 2)):
        np.save(os.path.join(d, f"{k}_idx.npy"), np.array([v]))
    sps.save_npz(os.path.join(d, "new_profile_feature.npz"),
                 sps.csr_matrix(rng.random((gid.shape[0], 10))
                                .astype(np.float32)))


def write_graphsaint(d, multilabel=False):
    rng = np.random.default_rng(0)
    n = 30
    os.makedirs(d, exist_ok=True)
    sps.save_npz(os.path.join(d, "adj_full.npz"),
                 sps.random(n, n, density=0.2, format="csr", random_state=1,
                            dtype=np.float32))
    np.save(os.path.join(d, "feats.npy"), rng.normal(size=(n, 6)))
    cmap = {str(i): ([int(b) for b in rng.random(4) < 0.5] if multilabel
                     else int(i % 7)) for i in range(n)}
    with open(os.path.join(d, "class_map.json"), "w") as f:
        json.dump(cmap, f)
    with open(os.path.join(d, "role.json"), "w") as f:
        json.dump({"tr": list(range(20)), "va": list(range(20, 25)),
                   "te": list(range(25, 30))}, f)


def write_wikics(d):
    rng = np.random.default_rng(0)
    n, t = 20, 3
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "data.json"), "w") as f:
        json.dump({
            "features": rng.normal(size=(n, 5)).tolist(),
            "labels": (np.arange(n) % 4).tolist(),
            "links": [[int(j) for j in rng.integers(0, n, 2)]
                      for _ in range(n)],
            "train_masks": (rng.random((t, n)) < 0.5).tolist(),
            "val_masks": (rng.random((t, n)) < 0.2).tolist(),
            "stopping_masks": (rng.random((t, n)) < 0.2).tolist(),
            "test_mask": (rng.random(n) < 0.3).tolist(),
        }, f)


def write_geom_gcn(d, name="cornell"):
    rng = np.random.default_rng(0)
    n, dim = 12, 4
    os.makedirs(d, exist_ok=True)
    lines = ["node_id\tfeature\tlabel"]
    for i in range(n):
        fv = ",".join(str(round(float(v), 3)) for v in rng.random(dim))
        lines.append(f"{i}\t{fv}\t{i % 3}")
    with open(os.path.join(d, "out1_node_feature_label.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    edges = ["id1\tid2"] + [f"{a}\t{b}" for a, b in
                            rng.integers(0, n, (30, 2))]
    with open(os.path.join(d, "out1_graph_edges.txt"), "w") as f:
        f.write("\n".join(edges) + "\n")
    for i in range(10):
        np.savez(os.path.join(d, f"{name}_split_0.6_0.2_{i}.npz"),
                 train_mask=rng.random(n) < 0.6,
                 val_mask=rng.random(n) < 0.2,
                 test_mask=rng.random(n) < 0.2)


def write_sbm(d):
    rng = np.random.default_rng(3)
    os.makedirs(d, exist_ok=True)
    for name, classes in (("PATTERN", 2), ("CLUSTER", 6)):
        splits = []
        for count in (4, 2, 2):
            samples = []
            for _ in range(count):
                n = int(rng.integers(20, 40))
                w = (rng.random((n, n)) < 0.2).astype(np.float32)
                np.fill_diagonal(w, 0)
                samples.append({
                    "W": w, "node_feat": rng.integers(0, 3, n),
                    "node_label": rng.integers(0, classes, n)
                    .astype(np.int16)})
            splits.append(samples)
        with open(os.path.join(d, f"SBM_{name}.pkl"), "wb") as f:
            pickle.dump(splits, f)


SMILES = ["CC(=O)Nc1ccc(O)cc1", "NC(CC(=O)O)C(=O)O", "CC(C)C[C@@H](C(=O)O)N",
          "C1CCCCC1N", "[NH3+]CC(=O)[O-]", "c1ccccc1Br", "OC(=O)C#N",
          "C/C=C\\C", "ClC(Cl)(Cl)S", "CC(C)(C)[Si](C)(C)O"]


def write_lrgb(d):
    targets = ["Inertia_mass_a", "Inertia_mass_b", "Inertia_mass_c",
               "Inertia_valence_a", "Inertia_valence_b",
               "Inertia_valence_c", "length_a", "length_b", "length_c",
               "Spherocity", "Plane_best_fit"]
    rng = np.random.default_rng(5)
    os.makedirs(d, exist_ok=True)
    with gzip.open(os.path.join(d, "peptide_structure_dataset.csv.gz"),
                   "wt") as f:
        f.write(",".join(["smiles"] + targets) + "\n")
        for s in SMILES:
            vals = ",".join(f"{v:.4f}" for v in rng.normal(size=11))
            f.write(f"{s},{vals}\n")
    with gzip.open(os.path.join(d, "peptide_multi_class_dataset.csv.gz"),
                   "wt") as f:
        f.write("smiles,labels\n")
        for i, s in enumerate(SMILES):
            f.write(f'{s},"[{i % 10}, {(3 * i) % 10}]"\n')


def write_heterophilous(d, name="minesweeper"):
    rng = np.random.default_rng(4)
    n = 50
    os.makedirs(d, exist_ok=True)
    np.savez(os.path.join(d, f"{name}.npz"),
             edges=rng.integers(0, n, (120, 2)),
             node_features=rng.normal(size=(n, 7)),
             node_labels=rng.integers(0, 2, n),
             train_masks=rng.random((10, n)) < 0.5,
             val_masks=rng.random((10, n)) < 0.25,
             test_masks=rng.random((10, n)) < 0.25)


LAYOUTS = {
    "ppi": write_ppi, "superpixels": write_superpixels, "sst": write_sst,
    "fakenews": write_fakenews, "graphsaint": write_graphsaint,
    "graphsaint_multilabel": lambda d: write_graphsaint(d, True),
    "wikics": write_wikics, "geom_gcn": write_geom_gcn, "sbm": write_sbm,
    "lrgb": write_lrgb, "reddit": write_reddit,
    "heterophilous": write_heterophilous,
}


def raw(root, where):
    """A fixture directory (``fix:...``) or a layout written under
    ``root``."""
    if where.startswith("fix:"):
        return os.path.join(FIX, *where[4:].split("/"))
    d = os.path.join(str(root), where)
    if not os.path.exists(d):
        LAYOUTS[where](d)
    return d


# -- the parsers ---------------------------------------------------------------


PARSERS = {
    "parse_tu_raw": lambda p, r: p.parse_tu_raw(raw(r, "fix:tu"), "MUTAG"),
    "has_tu_raw": lambda p, r: (p.has_tu_raw(raw(r, "fix:tu"), "MUTAG"),
                                p.has_tu_raw(raw(r, "fix:tu"), "ENZYMES"),
                                p.has_tu_raw(None, "MUTAG")),
    "parse_qm9_npz": lambda p, r: p.parse_qm9_npz(raw(r, "fix:qm9")),
    "parse_qm9_npz keys": lambda p, r: p.parse_qm9_npz(
        raw(r, "fix:qm9"), ["mu", "gap"]),
    "qm9_molecule_edges": lambda p, r: p.qm9_molecule_edges(
        p.parse_qm9_npz(raw(r, "fix:qm9"))[1][:9], 1.5),
    "parse_kg_dir": lambda p, r: p.parse_kg_dir(raw(r, "fix:kg")),
    "has_kg_raw": lambda p, r: (p.has_kg_raw(raw(r, "fix:kg")),
                                p.has_kg_raw(str(r))),
    "parse_ntriples": lambda p, r: p.parse_ntriples(
        os.path.join(raw(r, "fix:rdf/aifb"), "fixture.nt")),
    "parse_rdf_dir": lambda p, r: p.parse_rdf_dir(
        raw(r, "fix:rdf/aifb"),
        entity_prefix="http://www.aifb.uni-karlsruhe.de/"),
    "has_rdf_raw": lambda p, r: (p.has_rdf_raw(raw(r, "fix:rdf/aifb")),
                                 p.has_rdf_raw(str(r))),
    "parse_movielens": lambda p, r: p.parse_movielens(
        raw(r, "fix:movielens")),
    "parse_ogb_nodeprop": lambda p, r: p.parse_ogb_nodeprop(
        raw(r, "fix:ogb"), "ogbn-arxiv"),
    "parse_ogb_nodeprop mid": lambda p, r: p.parse_ogb_nodeprop(
        raw(r, "fix:ogb"), "ogbn-arxiv_mid"),
    "has_ogb_raw": lambda p, r: (p.has_ogb_raw(raw(r, "fix:ogb"),
                                               "ogbn-arxiv"),
                                 p.has_ogb_raw(raw(r, "fix:ogb"),
                                               "ogbn-products")),
    "parse_bitcoinotc": lambda p, r: p.parse_bitcoinotc(raw(r, "fix:btc")),
    "parse_temporal_kg": lambda p, r: p.parse_temporal_kg(
        raw(r, "fix:tkg"), "train", 24.0),
    "parse_fraud_mat": lambda p, r: p.parse_fraud_mat(raw(r, "fix:fraud"),
                                                      "yelp"),
    "parse_ppi_dir": lambda p, r: p.parse_ppi_dir(raw(r, "ppi"), "train"),
    "parse_superpixel_pkl": lambda p, r: p.parse_superpixel_pkl(
        raw(r, "superpixels"), "MNIST", "train"),
    "parse_superpixel_pkl cifar features": lambda p, r: (
        p.parse_superpixel_pkl(raw(r, "superpixels"), "CIFAR10", "train",
                               use_feature=True)),
    "parse_sst_trees": lambda p, r: p.parse_sst_trees(raw(r, "sst"),
                                                      "train"),
    "parse_fakenews_dir": lambda p, r: p.parse_fakenews_dir(
        raw(r, "fakenews"), "profile"),
    "parse_graphsaint_dir": lambda p, r: p.parse_graphsaint_dir(
        raw(r, "graphsaint")),
    "parse_graphsaint_dir multilabel": lambda p, r: p.parse_graphsaint_dir(
        raw(r, "graphsaint_multilabel")),
    "parse_wikics_json": lambda p, r: p.parse_wikics_json(raw(r, "wikics")),
    "parse_geom_gcn_dir": lambda p, r: p.parse_geom_gcn_dir(
        raw(r, "geom_gcn"), "cornell"),
    "parse_sbm_pkl": lambda p, r: p.parse_sbm_pkl(raw(r, "sbm"), "CLUSTER",
                                                  "valid"),
    "smiles_to_graph": lambda p, r: [p.smiles_to_graph(s) for s in SMILES],
    "parse_lrgb_peptides struct": lambda p, r: p.parse_lrgb_peptides(
        raw(r, "lrgb"), "Peptides-struct"),
    "parse_lrgb_peptides func": lambda p, r: p.parse_lrgb_peptides(
        raw(r, "lrgb"), "Peptides-func"),
    "has_* of the written layouts": lambda p, r: (
        p.has_ppi_raw(raw(r, "ppi"), "train"),
        p.has_ppi_raw(raw(r, "ppi"), "test"),
        p.has_superpixel_raw(raw(r, "superpixels"), "CIFAR10", "train"),
        p.has_sst_raw(raw(r, "sst"), "train"),
        p.has_fakenews_raw(raw(r, "fakenews")),
        p.has_graphsaint_raw(raw(r, "graphsaint")),
        p.has_wikics_raw(raw(r, "wikics")),
        p.has_geom_gcn_raw(raw(r, "geom_gcn")),
        p.has_sbm_raw(raw(r, "sbm"), "PATTERN"),
        p.has_lrgb_raw(raw(r, "lrgb"), "Peptides-func"),
        p.has_bitcoinotc_raw(raw(r, "fix:btc")),
        p.has_temporal_kg_raw(raw(r, "fix:tkg"), "train"),
        p.has_fraud_raw(raw(r, "fix:fraud"), "amazon"),
        p.has_movielens_raw(raw(r, "fix:movielens"))),
}


@pytest.mark.parametrize("name", sorted(PARSERS))
def test_parser_matches_reference(name, tmp_path):
    got = PARSERS[name](tp, tmp_path)
    ref = PARSERS[name](jp, tmp_path)
    same_item(got, ref, name)


def test_parsers_export_the_reference_names():
    assert sorted(tp.__all__) == sorted(jp.__all__)
    public = {n for n in dir(jp) if n.startswith(("parse_", "has_"))}
    assert public <= set(dir(tp))


# -- the datasets' real-file branches ----------------------------------------


REAL = {
    "TUDataset MUTAG": lambda m, r, kw: m.TUDataset(
        "MUTAG", raw_dir=raw(r, "fix:tu"), **kw),
    "LegacyTUDataset MUTAG": lambda m, r, kw: m.LegacyTUDataset(
        "MUTAG", raw_dir=raw(r, "fix:tu"), **kw),
    "QM9Dataset": lambda m, r, kw: m.QM9Dataset(raw_dir=raw(r, "fix:qm9"),
                                                cutoff=3.0, **kw),
    "FB15k237Dataset": lambda m, r, kw: m.FB15k237Dataset(
        raw_dir=raw(r, "fix:kg"), **kw),
    "AIFBDataset": lambda m, r, kw: m.AIFBDataset(
        raw_dir=raw(r, "fix:rdf/aifb"), **kw),
    "AIFBDataset no reverse": lambda m, r, kw: m.AIFBDataset(
        raw_dir=raw(r, "fix:rdf/aifb"), insert_reverse=False, **kw),
    "MovieLensDataset": lambda m, r, kw: m.MovieLensDataset(
        raw_dir=raw(r, "fix:movielens"), **kw),
    "BitcoinOTCDataset": lambda m, r, kw: m.BitcoinOTCDataset(
        raw_dir=raw(r, "fix:btc"), **kw),
    "ICEWS18Dataset": lambda m, r, kw: m.ICEWS18Dataset(
        raw_dir=raw(r, "fix:tkg"), **kw),
    "GDELTDataset": lambda m, r, kw: m.GDELTDataset(
        raw_dir=raw(r, "fix:tkg"), **kw),
    "FraudYelpDataset": lambda m, r, kw: m.FraudYelpDataset(
        raw_dir=raw(r, "fix:fraud"), **kw),
    "FraudDataset split": lambda m, r, kw: m.FraudDataset(
        "yelp", raw_dir=raw(r, "fix:fraud"), train_size=0.5, val_size=0.2,
        random_seed=3, **kw),
    "PPIDataset": lambda m, r, kw: m.PPIDataset(
        "train", raw_dir=raw(r, "ppi"), **kw),
    "MNISTSuperPixelDataset": lambda m, r, kw: m.MNISTSuperPixelDataset(
        raw_dir=raw(r, "superpixels"), **kw),
    "CIFAR10SuperPixelDataset": lambda m, r, kw: (
        m.CIFAR10SuperPixelDataset(raw_dir=raw(r, "superpixels"),
                                   use_feature=True, **kw)),
    "SSTDataset": lambda m, r, kw: m.SSTDataset(
        mode="train", raw_dir=raw(r, "sst"), **kw),
    "FakeNewsDataset": lambda m, r, kw: m.FakeNewsDataset(
        raw_dir=raw(r, "fakenews"), **kw),
    "FlickrDataset": lambda m, r, kw: m.FlickrDataset(
        raw_dir=raw(r, "graphsaint"), **kw),
    "YelpDataset multilabel": lambda m, r, kw: m.YelpDataset(
        raw_dir=raw(r, "graphsaint_multilabel"), **kw),
    "WikiCSDataset": lambda m, r, kw: m.WikiCSDataset(
        raw_dir=raw(r, "wikics"), **kw),
    "CornellDataset": lambda m, r, kw: m.CornellDataset(
        raw_dir=raw(r, "geom_gcn"), **kw),
    "PATTERNDataset": lambda m, r, kw: m.PATTERNDataset(
        raw_dir=raw(r, "sbm"), **kw),
    "CLUSTERDataset test": lambda m, r, kw: m.CLUSTERDataset(
        mode="test", raw_dir=raw(r, "sbm"), **kw),
    "PeptidesStructuralDataset": lambda m, r, kw: (
        m.PeptidesStructuralDataset(raw_dir=raw(r, "lrgb"), **kw)),
    "PeptidesFunctionalDataset": lambda m, r, kw: (
        m.PeptidesFunctionalDataset(raw_dir=raw(r, "lrgb"), **kw)),
    "RedditDataset": lambda m, r, kw: m.RedditDataset(
        raw_dir=raw(r, "reddit"), **kw),
    "MinesweeperDataset": lambda m, r, kw: m.MinesweeperDataset(
        raw_dir=raw(r, "heterophilous"), **kw),
}


@pytest.mark.parametrize("name", sorted(REAL))
def test_real_files_dataset_matches_reference(name, tmp_path):
    tds = REAL[name](T, tmp_path, CPU)
    jds = REAL[name](J, tmp_path, {})
    same_dataset(tds, jds, name)


@pytest.mark.parametrize("name,gap", [("cora", False), ("citeseer", True),
                                      ("pubmed", False)])
@pytest.mark.parametrize("reverse", [False, True])
def test_planetoid_files_match_reference(name, gap, reverse, tmp_path):
    out = {}
    for side, m, kw in (("torch", T, CPU), ("jax", J, {})):
        d = tmp_path / side
        write_planetoid(str(d / name), name, gap=gap)
        out[side] = m.CitationGraphDataset(name, raw_dir=str(d),
                                           synthetic=False,
                                           reverse_edge=reverse, **kw)
    same_dataset(out["torch"], out["jax"], name)


@pytest.mark.parametrize("name", ["ogbn-arxiv", "ogbn-arxiv_mid"])
def test_from_ogb_matches_reference(name):
    tg = T.from_ogb(name, root=os.path.join(FIX, "ogb"), device="cpu")
    jg = J.from_ogb(name, root=os.path.join(FIX, "ogb"))
    same_graph(tg, jg, name)
    assert tg.ndata["label"].dtype.is_floating_point is False


def test_from_ogb_without_files_raises_as_the_reference():
    from dgl_tpu.base import DGLError as JDGLError
    from dgl_tpu_torch.base import DGLError

    with pytest.raises(DGLError):
        T.from_ogb("ogbn-products", root="/nonexistent", device="cpu")
    with pytest.raises(JDGLError):
        J.from_ogb("ogbn-products", root="/nonexistent")
