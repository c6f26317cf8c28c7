"""Deterministic synthetic datasets for hermetic (zero-egress) runs
(counterpart of ``dgl_tpu/data/synthetic.py``: every draw in the JAX
package's order, so a seed gives the same graph in both packages).

Mirrors the statistical shape of the reference's citation/Reddit/PPI
datasets: homophilous SBM structure + class-informative features, so GNN
training curves behave like the real data (accuracy well above chance,
GCN > MLP). Used as the ``synthetic=True`` fallback of the real loaders and
as the default benchmark inputs. Graphs and frames lie on ``device``
(``"cuda"`` unless the caller asks for the CPU); labels and ids are
int64.
"""
from __future__ import annotations

import zlib

import numpy as np
import torch

from .dgl_dataset import DGLDataset
from .utils import to_tensor

__all__ = [
    "synthetic_classification_graph",
    "SyntheticDataset",
    "RedditDataset",
    "PPIDataset",
]


def _bow_features(rng, labels, num_classes, vocab, *, words_per_doc,
                  topic_words, topic_mass, topic_mix=0.0):
    """Planted-topic binary bag-of-words, row-normalized (see
    synthetic_classification_graph docstring)."""
    n = labels.shape[0]
    T = max(1, min(int(topic_words), vocab // num_classes))
    kmax = max(4, int(words_per_doc * 3))
    k = np.clip(rng.poisson(words_per_doc, n), 1, kmax)
    topical = rng.random((n, kmax)) < topic_mass
    # word ambiguity: some topical draws come from a WRONG class's block
    wrong = rng.random((n, kmax)) < topic_mix
    shift = rng.integers(1, max(num_classes, 2), (n, kmax))
    cls = np.where(wrong, (labels[:, None] + shift) % num_classes,
                   labels[:, None])
    topic_pick = cls * T + rng.integers(0, T, (n, kmax))
    bg_pick = rng.integers(0, vocab, (n, kmax))
    words = np.where(topical, topic_pick, bg_pick)
    live = np.arange(kmax)[None, :] < k[:, None]
    feat = np.zeros((n, vocab), np.float32)
    feat[np.repeat(np.arange(n), live.sum(1)), words[live]] = 1.0
    feat /= np.maximum(feat.sum(1, keepdims=True), 1.0)
    return feat


def synthetic_classification_graph(
    num_nodes: int,
    num_edges: int,
    num_classes: int,
    feat_dim: int,
    *,
    homophily: float = 0.8,
    noise: float = 1.0,
    signal: float = 2.0,
    seed: int = 0,
    feature_mode: str = "gaussian",
    words_per_doc: float = 18.0,
    topic_words: int = 64,
    topic_mass: float = 0.75,
    topic_mix: float = 0.0,
    noise_hubs: float = 0.0,
    num_communities: int = 0,
    device="cuda",
):
    """SBM-style graph with planted classes.

    ``feature_mode="gaussian"``: dense class-centroid features; ``signal``
    scales the centroids so per-class separability is
    ~``signal*sqrt(2*feat_dim)/noise`` standard deviations — small values
    (e.g. 0.04 at 1433 dims) calibrate the synthetic stand-ins to the REAL
    datasets' published accuracy bands instead of saturating (see
    ``citation._CALIB``).

    ``feature_mode="bow"``: sparse planted-topic bag-of-words features,
    the structure the real planetoid datasets have (binary word
    indicators, ~``words_per_doc`` nnz/row, row-normalized like the
    reference's planetoid preprocessing ``citation_graph.py::_preprocess_features``).
    Each class owns a disjoint block of ``topic_words`` vocabulary words;
    a document draws each word from a class topic with probability
    ``topic_mass``, else from the whole vocabulary; a topical draw comes
    from the document's own class with probability ``1 - topic_mix`` and
    from a random other class otherwise (word ambiguity — the calibration
    lever that keeps accuracy off the ceiling, mirroring real citation
    vocab overlap). ``noise_hubs`` redirects that fraction of edge
    sources to a small set of high-degree nodes with background-only
    features (generic "survey paper" citations): mean aggregation (GCN)
    ingests their noise, attention (GAT) learns to down-weight them —
    reproducing the real-data GAT>GCN margin. Unlike gaussian
    features, BoW gives GAT's attention real structure to exploit
    (per-edge word overlap), fixing the synthetic GAT accuracy gap.

    Returns a homogeneous Graph on ``device`` with ndata: feat, label,
    train/val/test_mask.
    """
    from .. import convert

    rng = np.random.default_rng(seed)
    if num_communities:
        # real citation graphs are thousands of SMALL homophilous
        # clusters, not one giant block per class: a single-block SBM
        # saturates 2-hop label propagation at PubMed scale (3 classes)
        # and accuracy pins at ~1.0 regardless of feature noise. Here a
        # node belongs to one of ``num_communities`` clusters; the
        # cluster fixes its class; ``homophily`` is the probability an
        # edge stays INSIDE the cluster (rest are global-random).
        comm = rng.integers(0, num_communities, num_nodes)
        labels = comm % num_classes
        group = comm
        n_groups = num_communities
    else:
        labels = rng.integers(0, num_classes, num_nodes)
        group = labels
        n_groups = num_classes
    # intra-group edges with prob `homophily`
    src = rng.integers(0, num_nodes, num_edges)
    intra = rng.random(num_edges) < homophily
    # vectorized same-group dst pick (permute nodes grouped by group id)
    order = np.argsort(group, kind="stable")
    gstart = np.searchsorted(group[order], np.arange(n_groups + 1))
    lo = gstart[group[src]]
    width = np.maximum(gstart[group[src] + 1] - lo, 1)
    same = order[lo + (rng.random(num_edges) * width).astype(np.int64)]
    dst = np.where(intra, same, rng.integers(0, num_nodes, num_edges))
    hub_ids = None
    if noise_hubs > 0:
        n_hub = max(2, num_nodes // 64)
        hub_ids = rng.choice(num_nodes, n_hub, replace=False)
        redirect = rng.random(num_edges) < noise_hubs
        src[redirect] = hub_ids[rng.integers(0, n_hub, int(redirect.sum()))]
    if feature_mode == "bow":
        feat = _bow_features(
            rng, labels, num_classes, feat_dim,
            words_per_doc=words_per_doc, topic_words=topic_words,
            topic_mass=topic_mass, topic_mix=topic_mix,
        )
    else:
        centroids = rng.normal(size=(num_classes, feat_dim)) * signal
        feat = (centroids[labels]
                + rng.normal(size=(num_nodes, feat_dim)) * noise)
    if hub_ids is not None and feature_mode == "bow":
        # hubs carry only background words: no class signal
        feat[hub_ids] = _bow_features(
            rng, labels[hub_ids], num_classes, feat_dim,
            words_per_doc=words_per_doc, topic_words=topic_words,
            topic_mass=0.0)

    g = convert.graph((src, dst), num_nodes=num_nodes, device=device)
    g.ndata["feat"] = to_tensor(feat, device, torch.float32)
    g.ndata["label"] = to_tensor(labels, device)
    perm = rng.permutation(num_nodes)
    n_train = int(num_nodes * 0.6)
    n_val = int(num_nodes * 0.2)
    train_mask = np.zeros(num_nodes, bool)
    val_mask = np.zeros(num_nodes, bool)
    test_mask = np.zeros(num_nodes, bool)
    train_mask[perm[:n_train]] = True
    val_mask[perm[n_train : n_train + n_val]] = True
    test_mask[perm[n_train + n_val :]] = True
    g.ndata["train_mask"] = to_tensor(train_mask, device)
    g.ndata["val_mask"] = to_tensor(val_mask, device)
    g.ndata["test_mask"] = to_tensor(test_mask, device)
    return g


class SyntheticDataset(DGLDataset):
    """Single synthetic node-classification graph."""

    def __init__(
        self,
        name="synthetic",
        num_nodes=1000,
        num_edges=8000,
        num_classes=7,
        feat_dim=64,
        seed=0,
        transform=None,
        device="cuda",
        **kwargs,
    ):
        self._cfg = (num_nodes, num_edges, num_classes, feat_dim, seed)
        self._num_classes = num_classes
        super().__init__(name=name, transform=transform, device=device)

    def process(self):
        n, e, c, d, s = self._cfg
        self._g = synthetic_classification_graph(n, e, c, d, seed=s,
                                                 device=self.device)

    def __getitem__(self, idx):
        assert idx == 0
        return self._apply_transform(self._g)

    def __len__(self):
        return 1

    @property
    def num_classes(self):
        return self._num_classes


class RedditDataset(SyntheticDataset):
    """Reddit dataset (reference ``data/reddit.py``).

    With ``raw_dir`` containing the real files (``reddit_data.npz`` with
    feature/label/node_types arrays + ``reddit_graph.npz`` scipy CSR, the
    data.dgl.ai layout), loads them; otherwise a scaled-down synthetic
    stand-in (``full_scale=True`` for reference-sized structure).
    """

    def __init__(self, full_scale=False, raw_dir=None, transform=None,
                 device="cuda", **kwargs):
        self._real_dir = raw_dir
        n = 232_965 if full_scale else 20_000
        e = 114_615_892 if full_scale else 400_000
        super().__init__(
            name="reddit_synthetic",
            num_nodes=n,
            num_edges=e,
            num_classes=41,
            feat_dim=602,
            seed=41,
            transform=transform,
            device=device,
        )

    def process(self):
        import os

        d = self._real_dir
        if d and os.path.exists(os.path.join(d, "reddit_data.npz")):
            self._g = self._process_real(d, self.device)
            return
        super().process()

    @staticmethod
    def _process_real(d, device):
        import os

        import scipy.sparse as sp

        from .. import convert

        data = np.load(os.path.join(d, "reddit_data.npz"))
        adj = sp.load_npz(os.path.join(d, "reddit_graph.npz")).tocoo()
        g = convert.graph(
            (adj.row.astype(np.int64), adj.col.astype(np.int64)),
            num_nodes=data["feature"].shape[0], device=device,
        )
        g.ndata["feat"] = to_tensor(data["feature"], device, torch.float32)
        g.ndata["label"] = to_tensor(data["label"].astype(np.int32), device)
        types = data["node_types"]  # 1=train, 2=val, 3=test
        g.ndata["train_mask"] = to_tensor(types == 1, device)
        g.ndata["val_mask"] = to_tensor(types == 2, device)
        g.ndata["test_mask"] = to_tensor(types == 3, device)
        return g


class PPIDataset(DGLDataset):
    """PPI multi-graph multilabel dataset (reference ``data/ppi.py``:
    24 graphs, 121 labels). With ``raw_dir`` holding the real GraphSAGE
    distribution ({mode}_graph.json node-link + feats/labels/graph_id
    .npy), parses it (``parsers.parse_ppi_dir``); otherwise a synthetic
    stand-in (6 small graphs per split)."""

    def __init__(self, mode="train", raw_dir=None, transform=None,
                 device="cuda", **kwargs):
        assert mode in ("train", "valid", "test")
        self.mode = mode
        self._ppi_raw_dir = raw_dir
        super().__init__(name=f"ppi_synthetic_{mode}", transform=transform,
                         device=device)

    def _process_real(self):
        from .. import convert
        from .parsers import parse_ppi_dir

        device = self.device
        edges, feats, labels, graph_id = parse_ppi_dir(
            self._ppi_raw_dir, self.mode)
        self._graphs = []
        for gid in np.unique(graph_id):
            nodes = np.nonzero(graph_id == gid)[0]
            remap = -np.ones(graph_id.shape[0], np.int64)
            remap[nodes] = np.arange(nodes.shape[0])
            emask = (graph_id[edges[0]] == gid) & (graph_id[edges[1]] == gid)
            g = convert.graph(
                (remap[edges[0][emask]], remap[edges[1][emask]]),
                num_nodes=nodes.shape[0], device=device)
            g.ndata["feat"] = to_tensor(feats[nodes], device)
            g.ndata["label"] = to_tensor(labels[nodes], device)
            self._graphs.append(g)

    def process(self):
        from .parsers import has_ppi_raw

        if has_ppi_raw(self._ppi_raw_dir, self.mode):
            self._process_real()
            return
        seed = {"train": 0, "valid": 100, "test": 200}[self.mode]
        count = {"train": 20, "valid": 2, "test": 2}[self.mode]
        rng = np.random.default_rng(seed)
        self._graphs = []
        for i in range(count):
            n = int(rng.integers(500, 800))
            e = n * 10
            g = synthetic_classification_graph(
                n, e, 10, 50, seed=seed + i, device=self.device
            )
            labels01 = rng.random((n, 121)) < 0.1
            g.ndata["label"] = to_tensor(labels01, self.device,
                                         torch.float32)
            self._graphs.append(g)

    def __getitem__(self, idx):
        return self._apply_transform(self._graphs[idx])

    def __len__(self):
        return len(self._graphs)

    @property
    def num_labels(self):
        return 121


def synthetic_hetero_graph(
    num_nodes_dict=None,
    num_edges_dict=None,
    num_classes: int = 8,
    feat_dim: int = 64,
    target_ntype: str = "paper",
    signal: float = 2.0,
    seed: int = 0,
    device="cuda",
):
    """ogbn-mag-shaped heterograph (reference ``data/adapter.py`` OGB mag):
    paper/author/institution/field nodes, 4 relation types, classes planted
    on the target ntype with homophilous paper-paper citations; on
    ``device``."""
    from .. import convert

    rng = np.random.default_rng(seed)
    if num_nodes_dict is None:
        num_nodes_dict = {
            "paper": 2000, "author": 1200, "institution": 100, "field": 200
        }
    if num_edges_dict is None:
        num_edges_dict = {
            ("paper", "cites", "paper"): 8000,
            ("author", "writes", "paper"): 6000,
            ("author", "affiliated_with", "institution"): 1500,
            ("paper", "has_topic", "field"): 4000,
        }
    n_paper = num_nodes_dict[target_ntype]
    labels = rng.integers(0, num_classes, n_paper)
    data = {}
    for cet, ne in num_edges_dict.items():
        st, _, dt = cet
        src = rng.integers(0, num_nodes_dict[st], ne)
        if st == target_ntype and dt == target_ntype:
            # homophilous citations
            order = np.argsort(labels, kind="stable")
            starts = np.searchsorted(labels[order], np.arange(num_classes + 1))
            dst = np.empty(ne, dtype=np.int64)
            for i in range(ne):
                if rng.random() < 0.75:
                    c = labels[src[i]]
                    lo, hi = starts[c], starts[c + 1]
                    dst[i] = order[rng.integers(lo, hi)] if hi > lo else rng.integers(0, n_paper)
                else:
                    dst[i] = rng.integers(0, n_paper)
        else:
            dst = rng.integers(0, num_nodes_dict[dt], ne)
        data[cet] = (src, dst)
    g = convert.heterograph(data, num_nodes_dict=num_nodes_dict,
                            device=device)
    centroids = rng.normal(size=(num_classes, feat_dim)) * signal
    g._node_frames.setdefault(target_ntype, {})["feat"] = to_tensor(
        centroids[labels] + rng.normal(size=(n_paper, feat_dim)), device,
        torch.float32,
    )
    g._node_frames[target_ntype]["label"] = to_tensor(labels, device)
    for nt, n in num_nodes_dict.items():
        if nt != target_ntype:
            g._node_frames.setdefault(nt, {})["feat"] = to_tensor(
                rng.normal(size=(n, feat_dim)), device, torch.float32
            )
    perm = rng.permutation(n_paper)
    masks = {}
    n_train = int(n_paper * 0.6)
    n_val = int(n_paper * 0.2)
    for name, sl in (
        ("train_mask", perm[:n_train]),
        ("val_mask", perm[n_train : n_train + n_val]),
        ("test_mask", perm[n_train + n_val :]),
    ):
        m = np.zeros(n_paper, bool)
        m[sl] = True
        g._node_frames[target_ntype][name] = to_tensor(m, device)
    return g


class SyntheticHeteroDataset(DGLDataset):
    """ogbn-mag-shaped dataset (the R-GCN north-star config)."""

    def __init__(self, num_classes=8, transform=None, device="cuda",
                 **kwargs):
        self._num_classes = num_classes
        super().__init__(name="synthetic_hetero", transform=transform,
                         device=device)

    def process(self):
        self._g = synthetic_hetero_graph(num_classes=self._num_classes,
                                         device=self.device)

    def __getitem__(self, idx):
        assert idx == 0
        return self._apply_transform(self._g)

    def __len__(self):
        return 1

    @property
    def num_classes(self):
        return self._num_classes

    @property
    def predict_ntype(self):
        return "paper"


class KnowledgeGraphDataset(DGLDataset):
    """FB15k237-shaped KG dataset (reference ``data/knowledge_graph.py``):
    (head, relation, tail) triples with train/valid/test splits; synthetic
    fallback plants relation-consistent clusters so TransE/R can learn."""

    def __init__(self, name="kg_synthetic", num_entities=500, num_rels=12,
                 num_triples=6000, seed=0, raw_dir=None, transform=None,
                 device="cuda", **kwargs):
        self._cfg = (num_entities, num_rels, num_triples, seed)
        super().__init__(name=name, raw_dir=raw_dir, transform=transform,
                         device=device)

    def process(self):
        from .parsers import has_kg_raw

        for cand in (self.raw_dir, self._raw_dir):
            if has_kg_raw(cand):
                self._process_raw(cand)
                return
        self._process_synthetic()

    def _process_raw(self, raw_dir):
        """Real triple files (reference ``knowledge_graph.py:86-148``)."""
        from .. import convert
        from .parsers import parse_kg_dir

        n, r, self.train, self.valid, self.test = parse_kg_dir(raw_dir)
        device = self.device
        g = convert.graph((self.train[:, 0], self.train[:, 2]), num_nodes=n,
                          device=device)
        E = g._relation(None).num_edges_padded
        et = np.zeros(E, np.int32)
        et[: self.train.shape[0]] = self.train[:, 1].astype(np.int32)
        g.edata["etype"] = to_tensor(et, device)
        self._g = g
        self.num_entities = n
        self.num_rels = r

    def _process_synthetic(self):
        from .. import convert

        n, r, t, s = self._cfg
        device = self.device
        rng = np.random.default_rng(s)
        # planted structure: each relation is (roughly) a shift permutation
        shift = rng.integers(1, n, r)
        heads = rng.integers(0, n, t)
        rels = rng.integers(0, r, t)
        noise = rng.random(t) < 0.1
        tails = np.where(
            noise, rng.integers(0, n, t), (heads + shift[rels]) % n
        )
        perm = rng.permutation(t)
        n_tr = int(t * 0.8)
        n_va = int(t * 0.1)
        self.train = np.stack(
            [heads[perm[:n_tr]], rels[perm[:n_tr]], tails[perm[:n_tr]]], 1
        )
        self.valid = np.stack(
            [heads[perm[n_tr : n_tr + n_va]], rels[perm[n_tr : n_tr + n_va]],
             tails[perm[n_tr : n_tr + n_va]]], 1
        )
        self.test = np.stack(
            [heads[perm[n_tr + n_va :]], rels[perm[n_tr + n_va :]],
             tails[perm[n_tr + n_va :]]], 1
        )
        g = convert.graph((heads[perm[:n_tr]], tails[perm[:n_tr]]),
                          num_nodes=n, device=device)
        g.edata["etype"] = to_tensor(rels[perm[:n_tr]].astype(np.int32),
                                     device)
        self._g = g
        self.num_entities = n
        self.num_rels = r

    def __getitem__(self, idx):
        assert idx == 0
        return self._apply_transform(self._g)

    def __len__(self):
        return 1


class GraphClassificationDataset(DGLDataset):
    """TUDataset/GINDataset-shaped multi-graph classification set (reference
    ``data/tu.py``, ``data/gindt.py``): B small graphs whose class is
    determined by planted structure (cycle vs. star motifs + feature shift)."""

    def __init__(self, name="graphcls_synthetic", num_graphs=120,
                 num_classes=2, feat_dim=8, seed=0, raw_dir=None,
                 transform=None, device="cuda", **kwargs):
        self._cfg = (num_graphs, num_classes, feat_dim, seed)
        self._num_classes = num_classes
        super().__init__(name=name, raw_dir=raw_dir, transform=transform,
                         device=device)

    def process(self):
        from .. import convert

        nb, c, d, s = self._cfg
        device = self.device
        rng = np.random.default_rng(s)
        self._graphs = []
        self._labels = []
        for i in range(nb):
            label = int(rng.integers(0, c))
            n = int(rng.integers(6, 14))
            # base random edges
            src = rng.integers(0, n, n * 2)
            dst = rng.integers(0, n, n * 2)
            if label == 0:
                # planted cycle
                ring = np.arange(n)
                src = np.concatenate([src, ring])
                dst = np.concatenate([dst, (ring + 1) % n])
            else:
                # planted star at node 0
                spokes = np.arange(1, n)
                src = np.concatenate([src, spokes])
                dst = np.concatenate([dst, np.zeros(n - 1, np.int64)])
            g = convert.graph((src, dst), num_nodes=n, device=device)
            feat = rng.normal(size=(n, d)).astype(np.float32)
            feat[:, 0] += label * 1.5  # feature signal too
            g.ndata["feat"] = to_tensor(feat, device)
            self._graphs.append(g)
            self._labels.append(label)
        self.labels = to_tensor(np.array(self._labels, np.int32), device)

    def __getitem__(self, idx):
        return self._apply_transform(self._graphs[idx]), self._labels[idx]

    def __len__(self):
        return len(self._graphs)

    @property
    def num_classes(self):
        return self._num_classes


def _make_named_dataset(name, n, e, c, d, homophily=0.8):
    """Factory for reference-named node-classification datasets with
    matching (nodes, edges, feat, classes) statistics (reference
    ``data/``: CoraFull, AmazonCoBuy, Coauthor, WikiCS, heterophilous
    suites, Flickr/Yelp graphsaint sets)."""

    class _Named(SyntheticDataset):
        def __init__(self, transform=None, device="cuda", **kwargs):
            super().__init__(
                name=name, num_nodes=n, num_edges=e, num_classes=c,
                feat_dim=d, seed=zlib.crc32(name.encode()) % 2**31,
                transform=transform, device=device,
            )

        def process(self):
            nn_, e_, c_, d_, s_ = self._cfg
            self._g = synthetic_classification_graph(
                nn_, e_, c_, d_, homophily=homophily, seed=s_,
                device=self.device
            )

    _Named.__name__ = name
    return _Named


# citation-family extensions (reference data/citation_graph.py CoraFull,
# data/gnn_benchmark.py Amazon/Coauthor)
CoraFullDataset = _make_named_dataset("CoraFullDataset", 19793, 126842, 70, 512)
AmazonCoBuyComputerDataset = _make_named_dataset(
    "AmazonCoBuyComputerDataset", 13752, 491722, 10, 767
)
AmazonCoBuyPhotoDataset = _make_named_dataset(
    "AmazonCoBuyPhotoDataset", 7650, 238162, 8, 745
)
CoauthorCSDataset = _make_named_dataset(
    "CoauthorCSDataset", 18333, 163788, 15, 300
)
CoauthorPhysicsDataset = _make_named_dataset(
    "CoauthorPhysicsDataset", 34493, 495924, 5, 400
)
_WikiCSBase = _make_named_dataset("WikiCSDataset", 11701, 431726, 10, 300)


class WikiCSDataset(_WikiCSBase):
    """With ``raw_dir`` holding the real ``data.json`` (reference
    ``data/wikics.py``), parses it; else synthetic-shaped."""

    def __init__(self, raw_dir=None, transform=None, device="cuda",
                 **kwargs):
        self._wikics_raw = raw_dir
        super().__init__(transform=transform, device=device, **kwargs)

    def process(self):
        from .parsers import has_wikics_raw, parse_wikics_json

        if not has_wikics_raw(self._wikics_raw):
            super().process()
            return
        from .. import convert
        from ..transforms import to_bidirected

        src, dst, feats, labels, masks = parse_wikics_json(
            self._wikics_raw)
        device = self.device
        g = to_bidirected(convert.graph((src, dst), num_nodes=feats.shape[0],
                                        device=device))
        g.ndata["feat"] = to_tensor(feats, device)
        g.ndata["label"] = to_tensor(labels.astype(np.int32), device)
        for k, v in masks.items():
            g.ndata[k] = to_tensor(v, device)
        self._g = g


def _graphsaint_dataset(name, n, e, c, d):
    base = _make_named_dataset(name, n, e, c, d)

    class _GS(base):
        def __init__(self, raw_dir=None, transform=None, device="cuda",
                     **kwargs):
            self._gs_raw = raw_dir
            super().__init__(transform=transform, device=device, **kwargs)

        def process(self):
            from .parsers import has_graphsaint_raw, parse_graphsaint_dir

            if not has_graphsaint_raw(self._gs_raw):
                super().process()
                return
            from .. import convert

            src, dst, feats, labels, masks = parse_graphsaint_dir(
                self._gs_raw)
            device = self.device
            g = convert.graph((src, dst), num_nodes=feats.shape[0],
                              device=device)
            g.ndata["feat"] = to_tensor(feats, device)
            g.ndata["label"] = to_tensor(
                labels if labels.ndim == 2
                else labels.astype(np.int32), device)
            for k, v in masks.items():
                g.ndata[f"{k}_mask"] = to_tensor(v, device)
            self._g = g

    _GS.__name__ = name
    return _GS


# graphsaint suite (reference data/flickr.py, data/yelp.py): real
# adj_full.npz/feats.npy/class_map.json/role.json layout parsed when
# raw_dir is provided
FlickrDataset = _graphsaint_dataset("FlickrDataset", 89250, 899756, 7, 500)
YelpDataset = _graphsaint_dataset("YelpDataset", 716847, 13954819 // 10, 100, 300)
# heterophilous suite (reference data/geom_gcn.py: low homophily)
def _geom_gcn_dataset(cls_name, raw_name, n, e, c, d, hom):
    """Heterophilous suite with the real geom-gcn raw layout parsed when
    ``raw_dir`` is provided (reference ``data/geom_gcn.py``)."""
    base = _make_named_dataset(cls_name, n, e, c, d, hom)

    class _GG(base):
        def __init__(self, raw_dir=None, transform=None, device="cuda",
                     **kwargs):
            self._gg_raw = raw_dir
            super().__init__(transform=transform, device=device, **kwargs)

        def process(self):
            from .parsers import has_geom_gcn_raw, parse_geom_gcn_dir

            if not has_geom_gcn_raw(self._gg_raw):
                super().process()
                return
            from .. import convert

            src, dst, feats, labels, masks = parse_geom_gcn_dir(
                self._gg_raw, raw_name)
            device = self.device
            g = convert.graph((src, dst), num_nodes=feats.shape[0],
                              device=device)
            g.ndata["feat"] = to_tensor(feats, device)
            g.ndata["label"] = to_tensor(labels.astype(np.int32), device)
            for key, m in zip(("train_mask", "val_mask", "test_mask"),
                              masks):
                if m is not None:
                    g.ndata[key] = to_tensor(m, device)
            self._num_classes = int(labels.max()) + 1
            self._g = g

    _GG.__name__ = cls_name
    return _GG


ActorDataset = _geom_gcn_dataset(
    "ActorDataset", "film", 7600, 33544, 5, 931, 0.25)
ChameleonDataset = _geom_gcn_dataset(
    "ChameleonDataset", "chameleon", 2277, 36101, 5, 2325, 0.3)
SquirrelDataset = _geom_gcn_dataset(
    "SquirrelDataset", "squirrel", 5201, 217073, 5, 2089, 0.3)
CornellDataset = _geom_gcn_dataset(
    "CornellDataset", "cornell", 183, 295, 5, 1703, 0.2)
TexasDataset = _geom_gcn_dataset(
    "TexasDataset", "texas", 183, 309, 5, 1703, 0.2)
WisconsinDataset = _geom_gcn_dataset(
    "WisconsinDataset", "wisconsin", 251, 499, 5, 1703, 0.2)


def split_dataset(dataset, frac_list=(0.8, 0.1, 0.1), shuffle=False,
                  random_state=None):
    """Split a dataset into subsets (reference ``data/utils.py``
    ``split_dataset``): returns list of index-view subsets."""

    class _Subset:
        def __init__(self, ds, idx):
            self._ds = ds
            self._idx = idx

        def __getitem__(self, i):
            return self._ds[int(self._idx[i])]

        def __len__(self):
            return len(self._idx)

    n = len(dataset)
    idx = np.arange(n)
    if shuffle:
        np.random.default_rng(random_state).shuffle(idx)
    out = []
    lo = 0
    for i, f in enumerate(frac_list):
        hi = n if i == len(frac_list) - 1 else lo + int(n * f)
        out.append(_Subset(dataset, idx[lo:hi]))
        lo = hi
    return out


class FraudDataset(DGLDataset):
    """Fraud detection heterograph (reference ``data/fraud.py``:
    FraudYelpDataset/FraudAmazonDataset — one review/user node type with
    multiple relation types and a fraud/benign label; synthetic stand-in
    with planted anomalous structure)."""

    RELATIONS = {
        "yelp": ["net_rsr", "net_rtr", "net_rur"],
        "amazon": ["net_upu", "net_usu", "net_uvu"],
    }

    def __init__(self, name="yelp", num_nodes=2000, avg_degree=8,
                 fraud_frac=0.15, seed=0, raw_dir=None, transform=None,
                 train_size=0.7, val_size=0.1, random_seed=717,
                 device="cuda", **kwargs):
        if name not in self.RELATIONS:
            raise ValueError(f"name must be one of {list(self.RELATIONS)}")
        self._which = name
        self._cfg = (num_nodes, avg_degree, fraud_frac, seed)
        self._fraud_raw_dir = raw_dir
        self._split = (train_size, val_size, random_seed)
        super().__init__(name=f"fraud_{name}_synthetic", transform=transform,
                         device=device)

    def _process_real(self):
        """Real YelpChi.mat / Amazon.mat (reference ``fraud.py:118-140``):
        per-relation sparse adjacency + node features + binary labels,
        stratified-free random split by ``random_seed``."""
        from .. import convert
        from .parsers import parse_fraud_mat

        rels, feat, labels = parse_fraud_mat(self._fraud_raw_dir,
                                             self._which)
        n = feat.shape[0]
        device = self.device
        data = {("review", et, "review"): (s, d)
                for et, (s, d) in rels.items()}
        g = convert.heterograph(data, num_nodes_dict={"review": n},
                                device=device)
        g._node_frames.setdefault("review", {})["feature"] = to_tensor(
            feat, device)
        g._node_frames["review"]["label"] = to_tensor(
            labels.astype(np.int32), device)
        tr, va, seed = self._split
        perm = np.random.default_rng(seed).permutation(n)
        for key, sl in (("train_mask", perm[: int(n * tr)]),
                        ("val_mask", perm[int(n * tr): int(n * (tr + va))]),
                        ("test_mask", perm[int(n * (tr + va)):])):
            m = np.zeros(n, bool)
            m[sl] = True
            g._node_frames["review"][key] = to_tensor(m, device)
        self._g = g

    def process(self):
        from .. import convert
        from .parsers import has_fraud_raw

        if has_fraud_raw(self._fraud_raw_dir, self._which):
            self._process_real()
            return

        n, deg, frac, s = self._cfg
        device = self.device
        rng = np.random.default_rng(s)
        labels = (rng.random(n) < frac).astype(np.int32)
        benign = np.nonzero(labels == 0)[0]
        fraud = np.nonzero(labels == 1)[0]
        data = {}
        for i, et in enumerate(self.RELATIONS[self._which]):
            E = n * deg // len(self.RELATIONS[self._which])
            src = rng.integers(0, n, E)
            # fraud nodes connect disproportionately to random targets,
            # benign to benign (camouflage structure)
            dst = np.where(
                (labels[src] == 0) & (rng.random(E) < 0.8) & (benign.size > 0),
                benign[rng.integers(0, max(benign.size, 1), E)],
                rng.integers(0, n, E),
            )
            data[("review", et, "review")] = (src, dst)
        g = convert.heterograph(data, num_nodes_dict={"review": n},
                                device=device)
        feat = rng.normal(size=(n, 32)).astype(np.float32)
        feat[fraud] += rng.normal(size=(fraud.size, 32)) * 0.5 + 0.8
        g._node_frames.setdefault("review", {})["feature"] = to_tensor(
            feat, device)
        g._node_frames["review"]["label"] = to_tensor(labels, device)
        perm = rng.permutation(n)
        for key, sl in (("train_mask", perm[: int(n * 0.4)]),
                        ("val_mask", perm[int(n * 0.4): int(n * 0.6)]),
                        ("test_mask", perm[int(n * 0.6):])):
            m = np.zeros(n, bool)
            m[sl] = True
            g._node_frames["review"][key] = to_tensor(m, device)
        self._g = g

    def __getitem__(self, idx):
        assert idx == 0
        return self._apply_transform(self._g)

    def __len__(self):
        return 1

    @property
    def num_classes(self):
        return 2
