"""Reference-named dataset tail (counterpart of
``dgl_tpu/data/named_extra.py``): KG, RDF, molecular, superpixel, GNN
benchmark, temporal-KG, signed/temporal and misc datasets.

Like the rest of ``dgl_tpu.data`` these default to deterministic
synthetic generators with reference-matching statistics and task
structure (reference modules cited per class); real raw files can be
dropped into ``raw_dir`` where a parser exists. Graphs and frames lie on
``device``; integer frames and labels are int64.
"""
from __future__ import annotations

import zlib

import numpy as np

from .dgl_dataset import DGLDataset
from .synthetic import (
    FraudDataset,
    GraphClassificationDataset,
    KnowledgeGraphDataset,
    SyntheticDataset,
    synthetic_classification_graph,
    synthetic_hetero_graph,
)
from .utils import to_tensor

__all__ = [
    "FB15kDataset", "FB15k237Dataset", "WN18Dataset",
    "AIFBDataset", "MUTAGDataset", "BGSDataset", "AMDataset",
    "QM7bDataset", "QM9Dataset", "QM9EdgeDataset", "ZINCDataset",
    "MNISTSuperPixelDataset", "CIFAR10SuperPixelDataset",
    "PATTERNDataset", "CLUSTERDataset",
    "ICEWS18Dataset", "GDELTDataset",
    "FraudYelpDataset", "FraudAmazonDataset",
    "BitcoinOTCDataset", "SSTDataset", "MovieLensDataset",
    "FakeNewsDataset", "TUDataset", "LegacyTUDataset", "LegacyPPIDataset",
]


# -- knowledge graphs (reference ``data/knowledge_graph.py``) ---------------


def _kg(name, ents, rels, triples):
    class _KG(KnowledgeGraphDataset):
        def __init__(self, transform=None, **kwargs):
            super().__init__(
                name=name, num_entities=ents, num_rels=rels,
                num_triples=triples, seed=zlib.crc32(name.encode()) % 2**31,
                transform=transform, **kwargs,
            )

    _KG.__name__ = name
    return _KG


FB15kDataset = _kg("FB15kDataset", 14951, 1345, 100000)
FB15k237Dataset = _kg("FB15k237Dataset", 14541, 237, 100000)
WN18Dataset = _kg("WN18Dataset", 40943, 18, 80000)


# -- RDF hetero node classification (reference ``data/rdf.py``) -------------


class _RDFDataset(DGLDataset):
    """Hetero entity-classification set with a ``predict_category``.

    When ``raw_dir`` holds real RDF exports — ``*.nt`` N-Triples plus
    ``trainingSet.tsv``/``testSet.tsv`` (the reference's extracted
    aifb-hetero layout, ``data/rdf.py:143-380``) — the real files are
    parsed into a heterograph whose node/edge types derive from the
    entity/predicate URIs; otherwise a synthetic hetero stand-in is
    generated."""

    CFG = ()  # (predict_category, num_classes)
    ENTITY_PREFIX = ""  # URI prefix for typed entities (reference rdf.py:607)

    def __init__(self, raw_dir=None, insert_reverse=True, transform=None,
                 device="cuda", **kwargs):
        cat, c = self.CFG
        self._cat = cat
        self._num_classes = c
        self._insert_reverse = insert_reverse
        super().__init__(name=type(self).__name__, raw_dir=raw_dir,
                         transform=transform, device=device)

    def process(self):
        from .parsers import has_rdf_raw

        for cand in (self.raw_dir, self._raw_dir):
            if has_rdf_raw(cand):
                self._process_raw(cand)
                return
        self._process_synthetic()

    def _process_raw(self, raw_dir):
        from .. import convert
        from .parsers import parse_rdf_dir

        triples, train_rows, test_rows = parse_rdf_dir(
            raw_dir, entity_prefix=self.ENTITY_PREFIX
        )
        device = self.device
        # assign per-type dense ids (reference rdf.py:176-260
        # process_raw_tuples builds the same ent2id maps via rdflib)
        ent2id, counts = {}, {}
        def eid(ent):
            if ent not in ent2id:
                ent2id[ent] = counts[ent[0]] = counts.get(ent[0], 0)
                counts[ent[0]] += 1
            return ent2id[ent]

        data_dict = {}
        for s, rel, o in triples:
            sid, oid = eid(s), eid(o)
            data_dict.setdefault((s[0], rel, o[0]), ([], []))
            data_dict[(s[0], rel, o[0])][0].append(sid)
            data_dict[(s[0], rel, o[0])][1].append(oid)
            if self._insert_reverse:
                rev = (o[0], "rev-" + rel, s[0])
                data_dict.setdefault(rev, ([], []))
                data_dict[rev][0].append(oid)
                data_dict[rev][1].append(sid)
        data_dict = {
            cet: (np.asarray(u, np.int64), np.asarray(v, np.int64))
            for cet, (u, v) in data_dict.items()
        }
        g = convert.heterograph(data_dict, dict(counts), device=device)
        # labels/masks on the predict category from the split TSVs
        # (reference rdf.py:355-380 load_data)
        label2id = {}
        n_cat = g.num_nodes(self._cat)
        labels = np.full(n_cat, -1, np.int64)
        train_mask = np.zeros(n_cat, bool)
        test_mask = np.zeros(n_cat, bool)
        from .parsers import _uri_entity

        for rows, mask in ((train_rows, train_mask), (test_rows, test_mask)):
            for uri, label in rows:
                ent = _uri_entity(uri, self.ENTITY_PREFIX)
                if ent is None or ent not in ent2id or ent[0] != self._cat:
                    continue
                if label not in label2id:
                    label2id[label] = len(label2id)
                idx = ent2id[ent]
                labels[idx] = label2id[label]
                mask[idx] = True
        frame = g._node_frames.setdefault(self._cat, {})
        frame["label"] = to_tensor(labels, device)
        frame["train_mask"] = to_tensor(train_mask, device)
        frame["test_mask"] = to_tensor(test_mask, device)
        if label2id:
            self._num_classes = len(label2id)
        self._g = g

    def _process_synthetic(self):
        from .. import convert

        device = self.device
        base = synthetic_hetero_graph(num_classes=self._num_classes,
                                      device=device)
        # rebuild with the labeled type renamed to this RDF set's predict
        # category (a shallow dict rename would leave the graph's cached
        # etype structures stale)
        mapping = {"paper": self._cat}
        data_dict = {}
        for (st, et, dt), rel in base._relations.items():
            E = rel.num_edges
            data_dict[(mapping.get(st, st), et, mapping.get(dt, dt))] = tuple(
                a[:E] for a in rel.host_arrays("src", "dst"))
        num_nodes = {
            mapping.get(nt, nt): base.num_nodes(nt) for nt in base.ntypes
        }
        g = convert.heterograph(data_dict, num_nodes, idtype=base.idtype,
                                device=device)
        for nt, frame in base._node_frames.items():
            g._node_frames.setdefault(mapping.get(nt, nt), {}).update(frame)
        self._g = g

    @property
    def predict_category(self):
        return self._cat

    @property
    def num_classes(self):
        return self._num_classes

    def __getitem__(self, idx):
        assert idx == 0
        return self._apply_transform(self._g)

    def __len__(self):
        return 1


class AIFBDataset(_RDFDataset):
    """(reference ``data/rdf.py`` AIFB: 4-class person affiliation)."""

    CFG = ("Personen", 4)
    ENTITY_PREFIX = "http://www.aifb.uni-karlsruhe.de/"


class MUTAGDataset(_RDFDataset):
    """(reference ``data/rdf.py`` MUTAG RDF: 2-class mutagenicity)."""

    CFG = ("d", 2)


class BGSDataset(_RDFDataset):
    """(reference ``data/rdf.py`` BGS: 2-class lithogenesis)."""

    CFG = ("Lexicon", 2)


class AMDataset(_RDFDataset):
    """(reference ``data/rdf.py`` AM: 11-class artifact category)."""

    CFG = ("proxy", 11)


# -- molecular regression (reference ``data/qm7b.py``, ``qm9.py``,
#    ``qm9_edge.py``; ZINC from ``data/zinc.py``) ---------------------------


class MoleculeRegressionDataset(DGLDataset):
    """Multi-graph regression: molecule-shaped graphs with 3D coordinates
    and per-graph target vectors; targets correlate with planted size and
    feature statistics so models can fit."""

    def __init__(self, name, num_graphs, num_targets, with_coords=True,
                 edge_feat_dim=0, seed=0, raw_dir=None, transform=None,
                 device="cuda", **kwargs):
        self._cfg = (num_graphs, num_targets, with_coords, edge_feat_dim,
                     seed)
        super().__init__(name=name, raw_dir=raw_dir, transform=transform,
                         device=device)

    def process(self):
        from .. import convert

        nb, t, coords, efd, s = self._cfg
        device = self.device
        rng = np.random.default_rng(s)
        self._graphs, targets = [], []
        for _ in range(nb):
            n = int(rng.integers(4, 24))
            # chain + random extra bonds: molecule-like sparsity
            chain = np.arange(n - 1)
            extra = rng.integers(0, n, max(1, n // 3))
            src = np.concatenate([chain, chain + 1, extra])
            dst = np.concatenate([chain + 1, chain,
                                  rng.integers(0, n, extra.shape[0])])
            g = convert.graph((src, dst), num_nodes=n, device=device)
            z = rng.integers(1, 10, n)  # atomic numbers
            g.ndata["node_type"] = to_tensor(z.astype(np.int32), device)
            if coords:
                pos = rng.normal(size=(n, 3)).astype(np.float32)
                g.ndata["R"] = to_tensor(pos, device)
            if efd:
                E = g._relation(None).num_edges_padded
                g.edata["edge_attr"] = to_tensor(
                    rng.normal(size=(E, efd)).astype(np.float32), device
                )
            self._graphs.append(g)
            base = np.array([n, z.mean(), z.std() + 1e-3], np.float32)
            w = rng.normal(size=(3, t)).astype(np.float32)
            targets.append(base @ w + rng.normal(size=t).astype(np.float32))
        self.label = to_tensor(np.stack(targets), device)

    def __getitem__(self, idx):
        return self._apply_transform(self._graphs[idx]), self.label[idx]

    def __len__(self):
        return len(self._graphs)


class QM7bDataset(MoleculeRegressionDataset):
    def __init__(self, num_graphs=400, transform=None, device="cuda",
                 **kwargs):
        super().__init__("QM7bDataset", num_graphs, 14, transform=transform,
                         device=device)


class QM9Dataset(MoleculeRegressionDataset):
    """12-target molecular regression; parses a real ``qm9_eV.npz``
    dropped into ``raw_dir`` (reference ``data/qm9.py:131-143``),
    building distance-cutoff bidirected graphs exactly like the
    reference's ``__getitem__`` (``qm9.py:200-208``); synthetic
    molecule-shaped fallback otherwise."""

    def __init__(self, label_keys=None, cutoff=5.0, num_graphs=400,
                 raw_dir=None, transform=None, device="cuda", **kwargs):
        self._label_keys = label_keys
        self.cutoff = cutoff
        super().__init__("QM9Dataset", num_graphs, 12, raw_dir=raw_dir,
                         transform=transform, device=device)

    def process(self):
        from .parsers import has_qm9_raw

        for cand in (self.raw_dir, self._raw_dir):
            if has_qm9_raw(cand):
                self._process_raw(cand)
                return
        super().process()

    def _process_raw(self, raw_dir):
        from .. import convert
        from .parsers import parse_qm9_npz, qm9_molecule_edges

        N, R, Z, labels = parse_qm9_npz(raw_dir, self._label_keys)
        device = self.device
        cumsum = np.concatenate([[0], np.cumsum(N)])
        self._graphs = []
        for i in range(len(N)):
            r = R[cumsum[i]: cumsum[i + 1]]
            z = Z[cumsum[i]: cumsum[i + 1]]
            u, v = qm9_molecule_edges(r, self.cutoff)
            g = convert.graph((u, v), num_nodes=int(N[i]), device=device)
            g.ndata["R"] = to_tensor(r, device)
            g.ndata["Z"] = to_tensor(z.astype(np.int32), device)
            g.ndata["node_type"] = g.ndata["Z"]
            self._graphs.append(g)
        self.label = to_tensor(labels, device)

    @property
    def num_tasks(self):
        return int(self.label.shape[1])


class QM9EdgeDataset(MoleculeRegressionDataset):
    def __init__(self, label_keys=None, num_graphs=400, transform=None,
                 device="cuda", **kwargs):
        super().__init__("QM9EdgeDataset", num_graphs, 19,
                         edge_feat_dim=4, transform=transform, device=device)


class ZINCDataset(MoleculeRegressionDataset):
    def __init__(self, mode="train", num_graphs=400, transform=None,
                 device="cuda", **kwargs):
        super().__init__(f"ZINCDataset_{mode}", num_graphs, 1,
                         with_coords=False, transform=transform,
                         device=device)


# -- superpixel graph classification (reference ``data/superpixel.py``) ------


class _SuperPixelDataset(GraphClassificationDataset):
    """With ``raw_dir`` holding the benchmarking-gnns pickles
    (``superpixels/mnist_75sp_{split}.pkl`` — reference
    ``data/superpixel.py``), parses the real data
    (``parsers.parse_superpixel_pkl``); else synthetic-shaped."""

    SP_NAME = "MNIST"

    def __init__(self, name, num_graphs, raw_dir=None, split="train",
                 use_feature=False, transform=None, device="cuda", **kwargs):
        self._sp_raw = raw_dir
        self._sp_split = split
        self._sp_use_feature = use_feature
        super().__init__(name=name, num_graphs=num_graphs, num_classes=10,
                         feat_dim=3, transform=transform, device=device)

    def process(self):
        from .parsers import has_superpixel_raw, parse_superpixel_pkl

        if not has_superpixel_raw(self._sp_raw, self.SP_NAME,
                                  self._sp_split):
            super().process()
            return
        from .. import convert

        samples = parse_superpixel_pkl(self._sp_raw, self.SP_NAME,
                                       self._sp_split,
                                       self._sp_use_feature)
        device = self.device
        self._graphs = []
        self._labels = []
        for src, dst, x, ev, y in samples:
            g = convert.graph((src, dst), num_nodes=x.shape[0],
                              device=device)
            g.ndata["feat"] = to_tensor(x, device)
            g.edata["feat"] = to_tensor(ev[:, None], device)
            self._graphs.append(g)
            self._labels.append(y)


class MNISTSuperPixelDataset(_SuperPixelDataset):
    def __init__(self, num_graphs=500, transform=None, **kwargs):
        super().__init__("MNISTSuperPixelDataset", num_graphs,
                         transform=transform, **kwargs)


class CIFAR10SuperPixelDataset(_SuperPixelDataset):
    SP_NAME = "CIFAR10"

    def __init__(self, num_graphs=500, transform=None, **kwargs):
        super().__init__("CIFAR10SuperPixelDataset", num_graphs,
                         transform=transform, **kwargs)


# -- GNN benchmark inductive node classification (reference
#    ``data/gnn_benchmark.py`` PATTERN/CLUSTER) ------------------------------


class _InductiveNodeDataset(DGLDataset):
    """Many SBM graphs with node labels (train on some graphs, eval on
    others). With the real benchmarking-gnns pickle in ``raw_dir``
    (``SBM_PATTERN.pkl`` / ``SBM_CLUSTER.pkl`` — the public
    distribution behind the graphs the reference re-serializes as DGL
    ``.bin``, reference ``data/pattern.py:91``), parses the real data
    (``parsers.parse_sbm_pkl``); else synthetic-shaped."""

    SBM_NAME = None  # "PATTERN" / "CLUSTER" on the real subclasses

    def __init__(self, name, num_graphs=100, num_classes=2, seed=0,
                 mode="train", raw_dir=None, transform=None, device="cuda",
                 **kwargs):
        self._cfg = (num_graphs, num_classes, seed)
        self._num_classes = num_classes
        self._mode = mode
        self._sbm_raw = raw_dir
        super().__init__(name=name, raw_dir=raw_dir, transform=transform,
                         device=device)

    def process(self):
        from .. import convert

        nb, c, s = self._cfg
        device = self.device
        if self.SBM_NAME is not None:
            from .parsers import has_sbm_raw, parse_sbm_pkl

            if has_sbm_raw(self._sbm_raw, self.SBM_NAME):
                self._graphs = []
                for src, dst, feat, label in parse_sbm_pkl(
                        self._sbm_raw, self.SBM_NAME, self._mode):
                    g = convert.graph((src, dst),
                                      num_nodes=int(feat.shape[0]),
                                      device=device)
                    g.ndata["feat"] = to_tensor(feat, device)
                    g.ndata["label"] = to_tensor(
                        label.astype(np.int32), device)
                    self._graphs.append(g)
                return
        rng = np.random.default_rng(s)
        self._graphs = []
        for _ in range(nb):
            n = int(rng.integers(40, 80))
            labels = rng.integers(0, c, n)
            p_in, p_out = 0.2, 0.02
            u = rng.integers(0, n, n * 10)
            v = rng.integers(0, n, n * 10)
            same = labels[u] == labels[v]
            keep = np.where(same, rng.random(n * 10) < p_in * 5,
                            rng.random(n * 10) < p_out * 5)
            g = convert.graph((u[keep], v[keep]), num_nodes=n, device=device)
            feat = (
                labels[:, None]
                + rng.normal(0, 2.0, (n, 4))
            ).astype(np.float32)
            g.ndata["feat"] = to_tensor(feat, device)
            g.ndata["label"] = to_tensor(labels.astype(np.int32), device)
            self._graphs.append(g)

    @property
    def num_classes(self):
        return self._num_classes

    def __getitem__(self, idx):
        return self._apply_transform(self._graphs[idx])

    def __len__(self):
        return len(self._graphs)


class PATTERNDataset(_InductiveNodeDataset):
    SBM_NAME = "PATTERN"

    def __init__(self, mode="train", raw_dir=None, transform=None,
                 device="cuda", **kwargs):
        super().__init__("PATTERNDataset", num_classes=2, mode=mode,
                         raw_dir=raw_dir, transform=transform, device=device)


class CLUSTERDataset(_InductiveNodeDataset):
    SBM_NAME = "CLUSTER"

    def __init__(self, mode="train", raw_dir=None, transform=None,
                 device="cuda", **kwargs):
        super().__init__("CLUSTERDataset", num_classes=6, mode=mode,
                         raw_dir=raw_dir, transform=transform, device=device)


# -- temporal knowledge graphs (reference ``data/icews18.py``,
#    ``data/gdelt.py``) ------------------------------------------------------


class _TemporalKG(KnowledgeGraphDataset):
    """Temporal event KG. With real ``{mode}.txt`` TSV files in
    ``raw_dir`` (the reference's published layout: [head, rel, tail,
    time] int rows — ``icews18.py:92``), builds the reference's list of
    cumulative per-timestep graphs with ``edata['rel_type']``; otherwise
    one synthetic KG graph with random timestamps."""

    def __init__(self, name, ents, rels, triples, num_ts=24, transform=None,
                 mode="train", raw_dir=None, time_divisor=24.0, device="cuda",
                 **kwargs):
        self._num_ts = num_ts
        self._mode = mode
        self._kg_raw_dir = raw_dir
        self._time_divisor = time_divisor
        super().__init__(name=name, num_entities=ents, num_rels=rels,
                         num_triples=triples,
                         seed=zlib.crc32(name.encode()) % 2**31,
                         transform=transform, device=device)

    def process(self):
        from .parsers import has_temporal_kg_raw, parse_temporal_kg

        device = self.device
        if has_temporal_kg_raw(self._kg_raw_dir, self._mode):
            from .. import convert

            src, rel, dst, ti = parse_temporal_kg(
                self._kg_raw_dir, self._mode, self._time_divisor)
            start = int(ti[ti >= 0].min())
            self._graphs = []
            for i in range(start, int(ti.max()) + 1):
                m = ti <= i
                g = convert.graph((src[m], dst[m]),
                                  num_nodes=int(max(src.max(), dst.max())) + 1,
                                  device=device)
                E = g._relation(None).num_edges_padded
                rt = np.zeros(E, np.int64)
                rt[: int(m.sum())] = rel[m]
                g.edata["rel_type"] = to_tensor(rt, device)
                self._graphs.append(g)
            self._g = self._graphs[-1]
            return
        self._graphs = None
        super().process()
        rng = np.random.default_rng(1)
        E = self._g._relation(None).num_edges_padded
        self._g.edata["timestamp"] = to_tensor(
            rng.integers(0, self._num_ts, E).astype(np.int32), device
        )

    def __getitem__(self, idx):
        if getattr(self, "_graphs", None):
            return self._apply_transform(self._graphs[idx])
        return super().__getitem__(idx)

    def __len__(self):
        if getattr(self, "_graphs", None):
            return len(self._graphs)
        return super().__len__()


class ICEWS18Dataset(_TemporalKG):
    def __init__(self, mode="train", raw_dir=None, transform=None,
                 device="cuda", **kwargs):
        super().__init__("ICEWS18Dataset", 23033, 256, 60000,
                         transform=transform, mode=mode, raw_dir=raw_dir,
                         time_divisor=24.0, device=device)


class GDELTDataset(_TemporalKG):
    def __init__(self, mode="train", raw_dir=None, transform=None,
                 device="cuda", **kwargs):
        super().__init__("GDELTDataset", 7691, 240, 60000,
                         transform=transform, mode=mode, raw_dir=raw_dir,
                         time_divisor=15.0, device=device)


# -- fraud aliases (reference ``data/fraud.py``) -----------------------------


class FraudYelpDataset(FraudDataset):
    def __init__(self, transform=None, **kwargs):
        super().__init__(name="yelp", transform=transform, **kwargs)


class FraudAmazonDataset(FraudDataset):
    def __init__(self, transform=None, **kwargs):
        super().__init__(name="amazon", transform=transform, **kwargs)


# -- misc ---------------------------------------------------------------------


class BitcoinOTCDataset(DGLDataset):
    """Signed, timestamped trust network as temporal snapshots (reference
    ``data/bitcoin_otc.py``): each item is one time-slice graph with edge
    weights in [-10, 10]."""

    def __init__(self, num_snapshots=10, num_nodes=500, seed=0,
                 raw_dir=None, transform=None, device="cuda", **kwargs):
        self._cfg = (num_snapshots, num_nodes, seed)
        self._btc_raw_dir = raw_dir
        super().__init__(name="BitcoinOTCDataset", transform=transform,
                         device=device)

    def process(self):
        from .. import convert
        from .parsers import has_bitcoinotc_raw, parse_bitcoinotc

        device = self.device
        if has_bitcoinotc_raw(self._btc_raw_dir):
            # real soc-sign-bitcoinotc.csv(.gz): cumulative 14-day
            # snapshots with integer trust ratings (reference
            # ``bitcoinotc.py:100-120``)
            edges, rating, ti = parse_bitcoinotc(self._btc_raw_dir)
            n = int(edges.max()) + 1
            self._graphs = []
            for i in range(int(ti.max())):
                m = ti <= i
                g = convert.graph((edges[m, 0], edges[m, 1]), num_nodes=n,
                                  device=device)
                E = g._relation(None).num_edges_padded
                w = np.zeros(E, np.float32)
                w[: int(m.sum())] = rating[m]
                g.edata["h"] = to_tensor(w, device)
                self._graphs.append(g)
            return
        k, n, s = self._cfg
        rng = np.random.default_rng(s)
        self._graphs = []
        for _ in range(k):
            e = int(rng.integers(n, n * 3))
            g = convert.graph(
                (rng.integers(0, n, e), rng.integers(0, n, e)), num_nodes=n,
                device=device,
            )
            E = g._relation(None).num_edges_padded
            w = np.zeros(E, np.float32)
            w[:e] = rng.integers(-10, 11, e)
            g.edata["h"] = to_tensor(w, device)
            self._graphs.append(g)

    def __getitem__(self, idx):
        return self._apply_transform(self._graphs[idx])

    def __len__(self):
        return len(self._graphs)

    @property
    def is_temporal(self):
        return True


class SSTDataset(DGLDataset):
    """Sentiment trees (reference ``data/tree.py`` SSTDataset): binary
    trees whose nodes carry word ids and 5-way sentiment labels."""

    PAD_WORD = -1

    def __init__(self, mode="tiny", num_trees=200, vocab_size=300, seed=0,
                 raw_dir=None, vocab_file=None, transform=None, device="cuda",
                 **kwargs):
        self._cfg = (num_trees, vocab_size, seed)
        self._sst_raw = raw_dir
        self._sst_mode = "train" if mode == "tiny" else mode
        self._sst_vocab_file = vocab_file
        super().__init__(name=f"SSTDataset_{mode}", transform=transform,
                         device=device)

    def _process_real(self):
        from .. import convert
        from .parsers import parse_sst_trees

        trees, vocab = parse_sst_trees(self._sst_raw, self._sst_mode,
                                       self._sst_vocab_file)
        device = self.device
        self.vocab = vocab
        self.vocab_size = len(vocab)
        self._graphs = []
        for src, dst, x, y, mask in trees:
            g = convert.graph((src, dst), num_nodes=x.shape[0],
                              device=device)
            g.ndata["x"] = to_tensor(x, device)
            g.ndata["y"] = to_tensor(y, device)
            g.ndata["mask"] = to_tensor(mask, device)
            self._graphs.append(g)

    def process(self):
        from .parsers import has_sst_raw

        if has_sst_raw(self._sst_raw, self._sst_mode):
            self._process_real()
            return
        from .. import convert

        nb, vocab, s = self._cfg
        device = self.device
        rng = np.random.default_rng(s)
        self._graphs = []
        self.vocab_size = vocab
        for _ in range(nb):
            leaves = int(rng.integers(3, 10))
            n = 2 * leaves - 1
            # child -> parent edges of a left-leaning binary tree
            src, dst = [], []
            next_id = leaves
            frontier = list(range(leaves))
            while len(frontier) > 1:
                a = frontier.pop(0)
                b = frontier.pop(0)
                src += [a, b]
                dst += [next_id, next_id]
                frontier.append(next_id)
                next_id += 1
            g = convert.graph((np.array(src), np.array(dst)), num_nodes=n,
                              device=device)
            x = np.full(n, self.PAD_WORD, np.int64)
            x[:leaves] = rng.integers(0, vocab, leaves)
            g.ndata["x"] = to_tensor(x.astype(np.int32), device)
            g.ndata["y"] = to_tensor(
                rng.integers(0, 5, n).astype(np.int32), device
            )
            g.ndata["mask"] = to_tensor(
                (x != self.PAD_WORD).astype(np.int32), device
            )
            self._graphs.append(g)

    def __getitem__(self, idx):
        return self._apply_transform(self._graphs[idx])

    def __len__(self):
        return len(self._graphs)

    @property
    def num_classes(self):
        return 5


class MovieLensDataset(DGLDataset):
    """User-movie rating bipartite graph (reference
    ``data/movielens.py``): hetero graph with a rating per edge."""

    def __init__(self, name="ml-100k", num_users=300, num_movies=500,
                 num_ratings=5000, valid_ratio=0.1, test_ratio=0.1, seed=0,
                 raw_dir=None, transform=None, device="cuda", **kwargs):
        self._cfg = (num_users, num_movies, num_ratings, seed)
        self._which = name
        super().__init__(name=f"MovieLensDataset_{name}", raw_dir=raw_dir,
                         transform=transform, device=device)

    def process(self):
        from .parsers import has_movielens_raw

        for cand in (self.raw_dir, self._raw_dir):
            if has_movielens_raw(cand, self._which):
                self._process_raw(cand)
                return
        self._process_synthetic()

    def _process_raw(self, raw_dir):
        """Real ``u.data``/``ratings.dat`` files (reference
        ``movielens.py:257`` process)."""
        from .. import convert
        from .parsers import parse_movielens

        u, m, rating, ts, uids, iids = parse_movielens(raw_dir, self._which)
        device = self.device
        g = convert.heterograph(
            {("user", "rates", "movie"): (u, m),
             ("movie", "rated-by", "user"): (m, u)},
            {"user": len(uids), "movie": len(iids)}, device=device,
        )
        nr = rating.shape[0]
        for cet in g.canonical_etypes:
            E = g._relations[cet].num_edges_padded
            r = np.zeros(E, np.float32)
            r[:nr] = rating
            t = np.zeros(E, np.int64)
            t[:nr] = ts
            frame = g._edge_frames.setdefault(cet, {})
            frame["rating"] = to_tensor(r, device)
            frame["timestamp"] = to_tensor(t.astype(np.int32), device)
        self._g = g

    def _process_synthetic(self):
        from .. import convert

        nu, nm, nr, s = self._cfg
        device = self.device
        rng = np.random.default_rng(s)
        u = rng.integers(0, nu, nr)
        m = rng.integers(0, nm, nr)
        g = convert.heterograph(
            {("user", "rates", "movie"): (u, m),
             ("movie", "rated-by", "user"): (m, u)},
            {"user": nu, "movie": nm}, device=device,
        )
        for cet in g.canonical_etypes:
            E = g._relations[cet].num_edges_padded
            r = np.zeros(E, np.float32)
            r[:nr] = rng.integers(1, 6, nr)
            g._edge_frames.setdefault(cet, {})["rating"] = to_tensor(r,
                                                                     device)
        self._g = g

    def __getitem__(self, idx):
        assert idx == 0
        return self._apply_transform(self._g)

    def __len__(self):
        return 1


class FakeNewsDataset(GraphClassificationDataset):
    """(reference ``data/fakenews.py``: binary graph classification over
    propagation trees). With ``raw_dir`` holding the real UPFD layout
    (A.txt + node_graph_id/graph_labels/{split}_idx .npy +
    new_{feature}_feature.npz), parses it; else synthetic-shaped."""

    def __init__(self, name="politifact", feature_name="profile",
                 raw_dir=None, transform=None, device="cuda", **kwargs):
        self._fn_raw = raw_dir
        self._fn_feature = feature_name
        super().__init__(name=f"FakeNewsDataset_{name}", num_graphs=150,
                         num_classes=2, feat_dim=10, transform=transform,
                         device=device)

    def process(self):
        from .parsers import has_fakenews_raw

        if not has_fakenews_raw(self._fn_raw):
            super().process()
            return
        from .. import convert
        from .parsers import parse_fakenews_dir

        src, dst, gid, labels, splits, feat = parse_fakenews_dir(
            self._fn_raw, self._fn_feature)
        device = self.device
        self.feature = to_tensor(feat, device)
        self.labels = to_tensor(np.asarray(labels).astype(np.int64), device)
        n_graphs = int(self.labels.shape[0])
        for k in ("train", "val", "test"):
            m = np.zeros(n_graphs, bool)
            m[splits[k]] = True
            setattr(self, f"{k}_mask", to_tensor(m, device))
        self._graphs = []
        self._labels = []
        for g_idx in range(int(gid.max()) + 1):
            nodes = np.nonzero(gid == g_idx)[0]
            remap = -np.ones(gid.shape[0], np.int64)
            remap[nodes] = np.arange(nodes.shape[0])
            emask = (gid[src] == g_idx) & (gid[dst] == g_idx)
            g = convert.graph((remap[src[emask]], remap[dst[emask]]),
                              num_nodes=nodes.shape[0], device=device)
            g.ndata["feat"] = to_tensor(feat[nodes], device)
            self._graphs.append(g)
            self._labels.append(int(labels[g_idx]))


class TUDataset(GraphClassificationDataset):
    """TU graph-kernel datasets (reference ``data/tu.py``): parses the
    real ``{name}_A.txt`` text-file family when present under
    ``raw_dir`` — edge list, graph indicator, graph labels, optional
    node/edge labels and attributes — falling back to the synthetic
    motif generator otherwise.

    Node features follow the reference's priority (``tu.py:156-200``):
    real-valued ``node_attributes`` if present, else one-hot
    ``node_labels``, else a constant vector of ``hidden_size``."""

    def __init__(self, name="ENZYMES", hidden_size=10, raw_dir=None,
                 num_graphs=120, num_classes=6, feat_dim=18,
                 transform=None, device="cuda", **kwargs):
        self._tu_name = name
        self.hidden_size = hidden_size
        super().__init__(name=f"TUDataset_{name}", num_graphs=num_graphs,
                         num_classes=num_classes, feat_dim=feat_dim,
                         raw_dir=raw_dir, transform=transform, device=device)

    def process(self):
        from .parsers import has_tu_raw

        for cand in (self._raw_dir, self.raw_dir):
            if has_tu_raw(cand, self._tu_name):
                self._process_raw(cand)
                return
        super().process()

    def _process_raw(self, raw_dir):
        from .. import convert
        from .parsers import parse_tu_raw

        raw = parse_tu_raw(raw_dir, self._tu_name)
        device = self.device
        indicator = raw["graph_indicator"]
        edges = raw["edges"]
        num_graphs = int(indicator.max()) + 1
        # per-graph node id windows (indicator is sorted by graph)
        starts = np.searchsorted(indicator, np.arange(num_graphs))
        ends = np.searchsorted(indicator, np.arange(num_graphs), "right")
        edge_graph = indicator[edges[:, 0]]

        if "node_attributes" in raw:
            feat = raw["node_attributes"]
        elif "node_labels" in raw:
            nl = raw["node_labels"]
            feat = np.eye(int(nl.max()) + 1, dtype=np.float32)[nl]
        else:
            feat = np.ones((indicator.shape[0], self.hidden_size),
                           np.float32)

        self._graphs, self._labels = [], []
        for gi in range(num_graphs):
            lo, hi = int(starts[gi]), int(ends[gi])
            e = edges[edge_graph == gi] - lo
            g = convert.graph((e[:, 0], e[:, 1]), num_nodes=hi - lo,
                              device=device)
            g.ndata["feat"] = to_tensor(feat[lo:hi], device)
            if "node_labels" in raw:
                g.ndata["node_labels"] = to_tensor(
                    raw["node_labels"][lo:hi].astype(np.int32), device
                )
            if "edge_attributes" in raw:
                E = g._relation(None).num_edges_padded
                ea = np.zeros((E, raw["edge_attributes"].shape[1]),
                              np.float32)
                ea[: e.shape[0]] = raw["edge_attributes"][edge_graph == gi]
                g.edata["edge_attr"] = to_tensor(ea, device)
            self._graphs.append(g)
        if "graph_labels" in raw:
            self._labels = [int(x) for x in raw["graph_labels"]]
            self._num_classes = int(raw["graph_labels"].max()) + 1
        else:
            self._labels = [float(x) for x in raw["graph_attributes"]]
            self._num_classes = None
        self.graph_labels = np.asarray(self._labels)
        self.labels = to_tensor(self.graph_labels, device)
        self.graph_lists = self._graphs
        self.max_num_node = int((ends - starts).max())

    @property
    def num_labels(self):
        return self._num_classes


class LegacyTUDataset(TUDataset):
    """(reference ``data/tu.py`` LegacyTUDataset): same raw format and
    feature priority as :class:`TUDataset`."""


class LegacyPPIDataset(DGLDataset):
    """(reference ``data/ppi.py`` LegacyPPIDataset): alias of PPIDataset."""

    def __new__(cls, *args, **kwargs):
        from .synthetic import PPIDataset

        return PPIDataset(*args, **kwargs)


# reference public name of the superpixel base (``data/superpixel.py``
# SuperPixelDataset, the torch Dataset MNIST/CIFAR build on)
SuperPixelDataset = _SuperPixelDataset


# -- LRGB long-range benchmark (reference ``data/lrgb.py:23,295,543,802``) ---


class PeptidesFunctionalDataset(GraphClassificationDataset):
    """Peptides-func (reference ``lrgb.py:295``): molecular graphs with
    10-way MULTILABEL targets. Stand-in follows the published statistics
    (15,535 peptides, ~150 nodes each) at reduced count; ``labels`` are
    (num_graphs, 10) float multi-hot."""

    LRGB_NAME = "Peptides-func"

    def __init__(self, num_graphs=400, raw_dir=None, transform=None,
                 device="cuda", **kwargs):
        self._nt = 10
        self._lrgb_raw = raw_dir
        self._lrgb_real = False
        super().__init__(
            name="PeptidesFunctionalDataset", num_graphs=num_graphs,
            num_classes=10, feat_dim=9, raw_dir=raw_dir,
            transform=transform, device=device,
        )
        if not self._lrgb_real:
            # synthetic path: integer labels -> multi-hot + extras
            rng = np.random.default_rng(7)
            multi = np.zeros((len(self._graphs), 10), np.float32)
            for i, l in enumerate(np.asarray(self._labels)):
                multi[i, int(l)] = 1.0
                extra = rng.integers(0, 10, rng.integers(0, 3))
                multi[i, extra] = 1.0
            self._labels = to_tensor(multi, self.device)
            self.labels = self._labels

    def process(self):
        self._lrgb_real = _load_lrgb(self, self.LRGB_NAME,
                                     self._lrgb_raw)
        if not self._lrgb_real:
            super().process()

    @property
    def num_tasks(self):
        return self._nt


class PeptidesStructuralDataset(GraphClassificationDataset):
    """Peptides-struct (reference ``lrgb.py:23``): 11 REGRESSION targets
    per molecular graph."""

    LRGB_NAME = "Peptides-struct"

    def __init__(self, num_graphs=400, raw_dir=None, transform=None,
                 device="cuda", **kwargs):
        self._nt = 11
        self._lrgb_raw = raw_dir
        self._lrgb_real = False
        super().__init__(
            name="PeptidesStructuralDataset", num_graphs=num_graphs,
            num_classes=11, feat_dim=9, raw_dir=raw_dir,
            transform=transform, device=device,
        )
        if not self._lrgb_real:
            rng = np.random.default_rng(11)
            self._labels = to_tensor(
                rng.normal(size=(len(self._graphs), 11)
                           ).astype(np.float32), self.device)
            self.labels = self._labels

    def process(self):
        self._lrgb_real = _load_lrgb(self, self.LRGB_NAME,
                                     self._lrgb_raw)
        if not self._lrgb_real:
            super().process()

    @property
    def num_tasks(self):
        return self._nt


def _load_lrgb(ds, lrgb_name, raw_dir):
    """Real-data path for the LRGB peptides sets: with the published
    CSV in ``raw_dir`` (reference ``data/lrgb.py:145,408``), parse
    SMILES into graphs (``parsers.smiles_to_graph`` — dependency-free
    reader, see its documented divergence from rdkit features)."""
    from .parsers import has_lrgb_raw, parse_lrgb_peptides

    if not has_lrgb_raw(raw_dir, lrgb_name):
        return False
    from .. import convert

    graphs, targets = parse_lrgb_peptides(raw_dir, lrgb_name)
    device = ds.device
    ds._graphs = []
    for src, dst, nf, ef in graphs:
        g = convert.graph((src, dst), num_nodes=int(nf.shape[0]),
                          device=device)
        g.ndata["feat"] = to_tensor(nf, device)
        if ef.shape[0]:
            g.edata["feat"] = to_tensor(ef, device)
        ds._graphs.append(g)
    ds._labels = to_tensor(targets, device)
    ds.labels = ds._labels
    return True


class _SuperpixelNodeDataset(DGLDataset):
    """Node-classification over superpixel graphs (reference
    ``lrgb.py:543,802`` VOC/COCO-SP): many graphs, each node labeled with
    a semantic class."""

    def __init__(self, name, num_graphs, num_classes, feat_dim=14,
                 seed=0, transform=None, device="cuda", **kwargs):
        self._cfg = (num_graphs, num_classes, feat_dim, seed)
        self._num_classes = num_classes
        super().__init__(name=name, transform=transform, device=device)

    def process(self):
        from .. import convert

        nb, c, d, s = self._cfg
        device = self.device
        rng = np.random.default_rng(s)
        self._graphs = []
        for i in range(nb):
            n = int(rng.integers(80, 200))
            # superpixel rag: knn over random 2d coords (the real VOC/COCO
            # graphs are 8-nn region adjacency graphs)
            coord = rng.random((n, 2))
            d2 = ((coord[:, None, :] - coord[None, :, :]) ** 2).sum(-1)
            nn_idx = np.argsort(d2, axis=1)[:, 1:9]
            src = np.repeat(np.arange(n), 8)
            dst = nn_idx.reshape(-1)
            g = convert.graph(
                (np.concatenate([src, dst]), np.concatenate([dst, src])),
                num_nodes=n, device=device,
            )
            labels = rng.integers(0, c, n).astype(np.int32)
            feat = rng.normal(size=(n, d)).astype(np.float32)
            feat[:, 0] = labels / c  # learnable signal
            g.ndata["feat"] = to_tensor(feat, device)
            g.ndata["label"] = to_tensor(labels, device)
            self._graphs.append(g)

    def __getitem__(self, idx):
        return self._apply_transform(self._graphs[idx])

    def __len__(self):
        return len(self._graphs)

    @property
    def num_classes(self):
        return self._num_classes


class VOCSuperpixelsDataset(_SuperpixelNodeDataset):
    """(reference ``lrgb.py:543``: 21 semantic classes)."""

    def __init__(self, num_graphs=200, transform=None, device="cuda",
                 **kwargs):
        super().__init__(
            "VOCSuperpixelsDataset", num_graphs, 21, feat_dim=14,
            transform=transform, device=device,
        )


class COCOSuperpixelsDataset(_SuperpixelNodeDataset):
    """(reference ``lrgb.py:802``: 81 semantic classes)."""

    def __init__(self, num_graphs=200, transform=None, device="cuda",
                 **kwargs):
        super().__init__(
            "COCOSuperpixelsDataset", num_graphs, 81, feat_dim=14,
            transform=transform, device=device,
        )


__all__ += [
    "SuperPixelDataset",
    "PeptidesFunctionalDataset",
    "PeptidesStructuralDataset",
    "VOCSuperpixelsDataset",
    "COCOSuperpixelsDataset",
]


# -- reference base-class and legacy-alias names ------------------------------


# base of the RDF entity-classification sets (reference ``data/rdf.py``
# RDFGraphDataset; AIFB/MUTAG/BGS/AM subclass it here as in the reference)
RDFGraphDataset = _RDFDataset


class Entity:
    """RDF entity (reference ``data/rdf.py:39``)."""

    def __init__(self, e_id, cls):
        self.id = e_id
        self.cls = cls

    def __str__(self):
        return f"{self.id}, {self.cls}"


class GNNBenchmarkDataset(SyntheticDataset):
    """Base of the Amazon/Coauthor co-purchase suites (reference
    ``data/gnn_benchmark.py`` GNNBenchmarkDataset): constructed by name."""

    _STATS = {
        "amazon_co_buy_computer": (13752, 491722, 10, 767),
        "amazon_co_buy_photo": (7650, 238162, 8, 745),
        "coauthor_cs": (18333, 163788, 15, 300),
        "coauthor_physics": (34493, 495924, 5, 400),
    }

    def __init__(self, name, transform=None, device="cuda", **kwargs):
        key = name.lower().replace("-", "_")
        if key not in self._STATS:
            raise ValueError(f"unknown GNN benchmark dataset {name!r}")
        n, e, c, d = self._STATS[key]
        super().__init__(
            name=key, num_nodes=n, num_edges=e, num_classes=c, feat_dim=d,
            seed=zlib.crc32(key.encode()) % 2**31, transform=transform,
            device=device,
        )


class AmazonCoBuy(GNNBenchmarkDataset):
    """Deprecated alias (reference ``data/gnn_benchmark.py`` AmazonCoBuy):
    name in {'computer'|'computers', 'photo'}."""

    def __init__(self, name, transform=None, device="cuda", **kwargs):
        key = {"computer": "amazon_co_buy_computer",
               "computers": "amazon_co_buy_computer",
               "photo": "amazon_co_buy_photo"}[name.lower()]
        super().__init__(key, transform=transform, device=device)


class Coauthor(GNNBenchmarkDataset):
    """Deprecated alias (reference ``gnn_benchmark.py`` Coauthor): name in
    {'cs', 'physics'}."""

    def __init__(self, name, transform=None, device="cuda", **kwargs):
        super().__init__(f"coauthor_{name.lower()}", transform=transform,
                         device=device)


class CoraFull(SyntheticDataset):
    """Deprecated alias of CoraFullDataset (reference
    ``data/citation_graph.py`` CoraFull)."""

    def __init__(self, transform=None, device="cuda", **kwargs):
        super().__init__(
            name="cora_full", num_nodes=19793, num_edges=126842,
            num_classes=70, feat_dim=512,
            seed=zlib.crc32(b"CoraFullDataset") % 2**31, transform=transform,
            device=device,
        )


class GeomGCNDataset(SyntheticDataset):
    """Base of the Geom-GCN heterophilous suite (reference
    ``data/geom_gcn.py`` GeomGCNDataset: chameleon/squirrel/actor/
    cornell/texas/wisconsin by name)."""

    _STATS = {
        "chameleon": (2277, 36101, 5, 2325),
        "squirrel": (5201, 217073, 5, 2089),
        "actor": (7600, 33544, 5, 931),
        "cornell": (183, 295, 5, 1703),
        "texas": (183, 309, 5, 1703),
        "wisconsin": (251, 499, 5, 1703),
    }

    def __init__(self, name, transform=None, device="cuda", **kwargs):
        key = name.lower()
        if key not in self._STATS:
            raise ValueError(f"unknown Geom-GCN dataset {name!r}")
        n, e, c, d = self._STATS[key]
        super().__init__(
            name=key, num_nodes=n, num_edges=e, num_classes=c, feat_dim=d,
            seed=zlib.crc32(key.encode()) % 2**31, transform=transform,
            device=device,
        )

    def process(self):
        n, e, c, d, s = self._cfg
        self._g = synthetic_classification_graph(
            n, e, c, d, homophily=0.25, seed=s, device=self.device
        )


class CoraBinary(DGLDataset):
    """Graph-classification pairs over cora-like subgraphs (reference
    ``data/citation_graph.py`` CoraBinary: (graph1, pmpd, label)
    triplets; here (graph, line-graph-coupling, label))."""

    def __init__(self, num_pairs: int = 100, seed: int = 0, transform=None,
                 device="cuda", **kwargs):
        self._cfg = (num_pairs, seed)
        super().__init__(name="cora_binary", transform=transform,
                         device=device)

    def process(self):
        nb, s = self._cfg
        rng = np.random.default_rng(s)
        self.graphs, self.pmpds, self.labels = [], [], []
        for i in range(nb):
            n = int(rng.integers(20, 60))
            g = synthetic_classification_graph(
                n, n * 4, 2, 16, seed=int(rng.integers(2**31)),
                device=self.device
            )
            self.graphs.append(g)
            # incidence-style coupling matrix as scipy coo (reference pmpd)
            src, dst = (a.cpu().numpy() for a in g.edges())
            import scipy.sparse as sp

            e = src.shape[0]
            pm = sp.coo_matrix(
                (np.ones(2 * e), (np.concatenate([src, dst]),
                                  np.tile(np.arange(e), 2))),
                shape=(n, e),
            )
            self.pmpds.append(pm)
            self.labels.append(int(rng.integers(0, 2)))

    def __getitem__(self, idx):
        return (
            self._apply_transform(self.graphs[idx]),
            self.pmpds[idx],
            self.labels[idx],
        )

    def __len__(self):
        return len(self.graphs)


__all__ += [
    "RDFGraphDataset",
    "Entity",
    "GNNBenchmarkDataset",
    "AmazonCoBuy",
    "Coauthor",
    "CoraFull",
    "GeomGCNDataset",
    "CoraBinary",
]
