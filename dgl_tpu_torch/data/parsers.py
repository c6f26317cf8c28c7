"""Real-format raw-file parsers for the data zoo (counterpart of
``dgl_tpu/data/parsers.py``, a copy of its numpy code: the port imports
nothing of the JAX package).

Zero-egress environments cannot download, but they CAN parse: every
function here operates on a pre-populated ``raw_dir`` laid out exactly
like the reference's extracted archives, so a user who copies their
existing DGL data directory over gets real data, and tests exercise the
real parse paths on tiny checked-in fixture files.

Formats covered (reference files cited per function):

- TU graph-kernel datasets   (reference ``python/dgl/data/tu.py:110-210``)
- QM9 ``qm9_eV.npz``         (reference ``python/dgl/data/qm9.py:131-143``)
- KG triple dirs             (reference ``python/dgl/data/knowledge_graph.py:86-275``)
- RDF N-Triples + split TSVs (reference ``python/dgl/data/rdf.py:143-380,670-700``)
- MovieLens ml-100k          (reference ``python/dgl/data/movielens.py:257``)
- OGB node-prop raw layout   (reference adapter usage of
  ``ogb.nodeproppred.NodePropPredDataset``; the on-disk csv.gz layout)

All functions are pure numpy — graph construction happens in the dataset
classes so these stay import-light and unit-testable.
"""
from __future__ import annotations

import gzip
import os
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "has_tu_raw", "parse_tu_raw",
    "has_qm9_raw", "parse_qm9_npz",
    "has_kg_raw", "parse_kg_dir",
    "has_rdf_raw", "parse_ntriples", "parse_rdf_dir",
    "has_movielens_raw", "parse_movielens",
    "has_ogb_raw", "parse_ogb_nodeprop",
]


# ---------------------------------------------------------------------------
# TU graph-kernel format (``{name}_A.txt`` family)
# ---------------------------------------------------------------------------


def _tu_file(raw_dir: str, name: str, category: str) -> str:
    # reference tu.py:274 _file_path: <raw>/<name>/<name>_<category>.txt
    for base in (os.path.join(raw_dir, name), raw_dir):
        p = os.path.join(base, f"{name}_{category}.txt")
        if os.path.exists(p):
            return p
    return os.path.join(raw_dir, name, f"{name}_{category}.txt")


def has_tu_raw(raw_dir: Optional[str], name: str) -> bool:
    if not raw_dir:
        return False
    return os.path.exists(_tu_file(raw_dir, name, "A")) and os.path.exists(
        _tu_file(raw_dir, name, "graph_indicator")
    )


def parse_tu_raw(raw_dir: str, name: str) -> Dict[str, np.ndarray]:
    """Parse the TU dataset text format into 0-based numpy arrays.

    Returns a dict with keys ``edges`` (E,2), ``graph_indicator`` (N,),
    and whichever of ``graph_labels``/``graph_attributes``/
    ``node_labels``/``node_attributes``/``edge_labels``/
    ``edge_attributes`` exist on disk. Ids are converted from the
    format's 1-based convention to 0-based; labels are densified to
    ``0..C-1`` (the raw files may use arbitrary label values).
    """
    edges = np.loadtxt(_tu_file(raw_dir, name, "A"), delimiter=",",
                       dtype=np.int64, ndmin=2) - 1
    indicator = np.loadtxt(_tu_file(raw_dir, name, "graph_indicator"),
                           dtype=np.int64, ndmin=1) - 1
    out: Dict[str, np.ndarray] = {"edges": edges,
                                  "graph_indicator": indicator}

    def _opt(category, **kw):
        p = _tu_file(raw_dir, name, category)
        if os.path.exists(p):
            out[category] = np.loadtxt(p, delimiter=",", ndmin=1, **kw)

    _opt("graph_labels", dtype=np.int64)
    _opt("graph_attributes", dtype=np.float64)
    _opt("node_labels", dtype=np.int64)
    _opt("edge_labels", dtype=np.int64)
    p = _tu_file(raw_dir, name, "node_attributes")
    if os.path.exists(p):
        out["node_attributes"] = np.loadtxt(p, delimiter=",", ndmin=2,
                                            dtype=np.float32)
    p = _tu_file(raw_dir, name, "edge_attributes")
    if os.path.exists(p):
        out["edge_attributes"] = np.loadtxt(p, delimiter=",", ndmin=2,
                                            dtype=np.float32)
    # densify labels: raw TU files use arbitrary ranges (e.g. {-1, 1}
    # or 1-based); map them onto 0..C-1 preserving sorted order
    for key in ("graph_labels", "node_labels", "edge_labels"):
        if key in out:
            uniq, inv = np.unique(out[key], return_inverse=True)
            out[key] = inv.astype(np.int64)
            out[key + "_values"] = uniq
    return out


# ---------------------------------------------------------------------------
# QM9 npz (keys: N, R, Z, + one array per target property)
# ---------------------------------------------------------------------------

QM9_LABEL_KEYS = [
    "mu", "alpha", "homo", "lumo", "gap", "r2", "zpve", "U0", "U",
    "H", "G", "Cv",
]


def has_qm9_raw(raw_dir: Optional[str]) -> bool:
    return bool(raw_dir) and os.path.exists(
        os.path.join(raw_dir, "qm9_eV.npz")
    )


def parse_qm9_npz(raw_dir: str, label_keys: Optional[Sequence[str]] = None):
    """Parse ``qm9_eV.npz`` (reference ``qm9.py:131``): concatenated
    per-atom charges ``Z`` and coordinates ``R`` with per-molecule atom
    counts ``N``, plus one target array per label key.

    Returns ``(N, R, Z, labels)`` where ``labels`` is (B, len(keys)).
    """
    data = np.load(os.path.join(raw_dir, "qm9_eV.npz"), allow_pickle=True)
    keys = list(label_keys or QM9_LABEL_KEYS)
    N = np.asarray(data["N"], dtype=np.int64)
    R = np.asarray(data["R"], dtype=np.float32)
    Z = np.asarray(data["Z"], dtype=np.int64)
    labels = np.stack([np.asarray(data[k], dtype=np.float32) for k in keys],
                      axis=1)
    return N, R, Z, labels


def qm9_molecule_edges(R: np.ndarray, cutoff: float = 5.0):
    """Distance-cutoff bidirected molecular edges (reference
    ``qm9.py:200-208``): all atom pairs within ``cutoff`` excluding
    self-loops."""
    dist = np.linalg.norm(R[:, None, :] - R[None, :, :], axis=-1)
    adj = (dist <= cutoff)
    np.fill_diagonal(adj, False)
    u, v = np.nonzero(adj)
    return u.astype(np.int64), v.astype(np.int64)


# ---------------------------------------------------------------------------
# Knowledge-graph triple directories (FB15k / FB15k-237 / WN18)
# ---------------------------------------------------------------------------


def _kg_root(raw_dir: str) -> Optional[str]:
    for base in (raw_dir, *(os.path.join(raw_dir, d)
                            for d in sorted(os.listdir(raw_dir))
                            if os.path.isdir(os.path.join(raw_dir, d)))):
        if os.path.exists(os.path.join(base, "train.txt")):
            return base
    return None


def has_kg_raw(raw_dir: Optional[str]) -> bool:
    return bool(raw_dir) and os.path.isdir(raw_dir) and (
        _kg_root(raw_dir) is not None
    )


def _read_dict_file(path: str) -> Dict[str, int]:
    # reference knowledge_graph.py:250 _read_dictionary: "<id>\t<name>"
    d: Dict[str, int] = {}
    with open(path) as f:
        for line in f:
            parts = line.strip().split("\t")
            if len(parts) >= 2:
                d[parts[1]] = int(parts[0])
    return d


def parse_kg_dir(raw_dir: str):
    """Parse an RGCN-style KG directory (reference
    ``knowledge_graph.py:86-118``): ``entities.dict``,
    ``relations.dict`` plus ``train/valid/test.txt`` of
    tab-separated ``head rel tail`` string triples.

    Missing dict files are rebuilt from the triples (sorted-name order).
    Returns ``(num_entities, num_rels, train, valid, test)`` with each
    split an (n, 3) int64 array of ``[head, rel, tail]`` rows.
    """
    root = _kg_root(raw_dir)
    if root is None:
        raise FileNotFoundError(f"no train.txt under {raw_dir}")

    def read_triples(split):
        p = os.path.join(root, f"{split}.txt")
        if not os.path.exists(p):
            return []
        rows = []
        with open(p) as f:
            for line in f:
                parts = line.strip().split("\t")
                if len(parts) == 3:
                    rows.append(parts)
        return rows

    raw = {s: read_triples(s) for s in ("train", "valid", "test")}
    ent_path = os.path.join(root, "entities.dict")
    rel_path = os.path.join(root, "relations.dict")
    if os.path.exists(ent_path):
        ent2id = _read_dict_file(ent_path)
    else:
        names = sorted({t[i] for rows in raw.values() for t in rows
                        for i in (0, 2)})
        ent2id = {n: i for i, n in enumerate(names)}
    if os.path.exists(rel_path):
        rel2id = _read_dict_file(rel_path)
    else:
        names = sorted({t[1] for rows in raw.values() for t in rows})
        rel2id = {n: i for i, n in enumerate(names)}

    def to_ids(rows):
        if not rows:
            return np.zeros((0, 3), np.int64)
        return np.array(
            [[ent2id[h], rel2id[r], ent2id[t]] for h, r, t in rows],
            dtype=np.int64,
        )

    return (len(ent2id), len(rel2id), to_ids(raw["train"]),
            to_ids(raw["valid"]), to_ids(raw["test"]))


# ---------------------------------------------------------------------------
# RDF entity-classification dirs (AIFB-style)
# ---------------------------------------------------------------------------

_NT_LINE = re.compile(
    r"^<([^>]*)>\s+<([^>]*)>\s+(<[^>]*>|\"(?:[^\"\\]|\\.)*\"(?:\^\^<[^>]*>|@\S+)?)\s*\.\s*$"
)


def has_rdf_raw(raw_dir: Optional[str]) -> bool:
    if not raw_dir or not os.path.isdir(raw_dir):
        return False
    has_nt = any(f.endswith(".nt") for f in os.listdir(raw_dir))
    return has_nt and os.path.exists(
        os.path.join(raw_dir, "trainingSet.tsv")
    )


def parse_ntriples(path: str) -> List[Tuple[str, str, str]]:
    """Line-based N-Triples parser (the reference uses rdflib over .n3;
    we support the equivalent .nt serialization without a dependency —
    reference ``rdf.py:159-174`` ``load_raw_tuples``). Literal objects
    are returned with their quotes stripped."""
    triples = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            m = _NT_LINE.match(line)
            if not m:
                continue
            s, p, o = m.group(1), m.group(2), m.group(3)
            if o.startswith("<"):
                o = o[1:-1]
            else:  # literal: strip quotes and any datatype/lang suffix
                o = o[1:o.rindex('"')]
                o = f"_literal:{o}"
            triples.append((s, p, o))
    return triples


def _uri_entity(uri: str, entity_prefix: str):
    """Split an entity URI into (type, instance) the way the reference's
    per-dataset ``parse_entity`` does (``rdf.py:672-684``: AIFB type is
    path segment 3, id is segment 5)."""
    if uri.startswith("_literal:"):
        return "_Literal", uri[len("_literal:"):]
    if entity_prefix and not uri.startswith(entity_prefix):
        return None
    tail = uri[len(entity_prefix):] if entity_prefix else uri
    parts = [p for p in re.split(r"[/#]", tail) if p]
    if not parts:
        return None
    cls = parts[0] if len(parts) > 1 else "_Entity"
    inst = parts[-1]
    return cls, inst


def _uri_relation(uri: str) -> str:
    parts = [p for p in re.split(r"[/#]", uri) if p]
    return parts[-1] if parts else uri


def parse_rdf_dir(raw_dir: str, entity_prefix: str = "",
                  label_col: int = -1, entity_col: int = 0):
    """Parse an RDF entity-classification dir: all ``*.nt`` files plus
    ``trainingSet.tsv``/``testSet.tsv`` (reference ``rdf.py:355-380``).

    Returns ``(triples, train_rows, test_rows)`` where triples are
    ((src_type, src_id), rel, (dst_type, dst_id)) with URI-derived
    types, and each split row is ``(entity_uri, label_str)``.
    """
    triples = []
    for fn in sorted(os.listdir(raw_dir)):
        if fn.endswith(".nt"):
            for s, p, o in parse_ntriples(os.path.join(raw_dir, fn)):
                se = _uri_entity(s, entity_prefix)
                oe = _uri_entity(o, entity_prefix)
                if se is None or oe is None:
                    continue
                triples.append((se, _uri_relation(p), oe))

    def read_split(fn):
        p = os.path.join(raw_dir, fn)
        rows = []
        if not os.path.exists(p):
            return rows
        with open(p) as f:
            header = True
            for line in f:
                parts = line.rstrip("\n").split("\t")
                if header:  # reference split files carry a header row
                    header = False
                    continue
                if len(parts) >= 2:
                    rows.append((parts[entity_col], parts[label_col]))
        return rows

    return triples, read_split("trainingSet.tsv"), read_split("testSet.tsv")


# ---------------------------------------------------------------------------
# MovieLens ml-100k
# ---------------------------------------------------------------------------


def _ml_root(raw_dir: str, name: str) -> Optional[str]:
    for base in (raw_dir, os.path.join(raw_dir, name)):
        if os.path.exists(os.path.join(base, "u.data")):
            return base
        if os.path.exists(os.path.join(base, "ratings.dat")):
            return base
    return None


def has_movielens_raw(raw_dir: Optional[str], name: str = "ml-100k") -> bool:
    return bool(raw_dir) and os.path.isdir(raw_dir) and (
        _ml_root(raw_dir, name) is not None
    )


def parse_movielens(raw_dir: str, name: str = "ml-100k"):
    """Parse MovieLens raw files (reference ``movielens.py:257`` process):
    ml-100k's tab-separated ``u.data`` (user, item, rating, timestamp)
    or ml-1m/10m's ``ratings.dat`` (``user::item::rating::ts``).

    Returns ``(user_ids, item_ids, ratings, timestamps)`` with ids
    remapped to dense 0-based ranges, plus the id maps.
    """
    root = _ml_root(raw_dir, name)
    if root is None:
        raise FileNotFoundError(f"no u.data/ratings.dat under {raw_dir}")
    p = os.path.join(root, "u.data")
    if os.path.exists(p):
        arr = np.loadtxt(p, dtype=np.int64, ndmin=2)
    else:
        rows = []
        with open(os.path.join(root, "ratings.dat")) as f:
            for line in f:
                parts = line.strip().split("::")
                if len(parts) == 4:
                    rows.append([int(float(x)) for x in parts])
        arr = np.asarray(rows, dtype=np.int64).reshape(-1, 4)
    users, items = arr[:, 0], arr[:, 1]
    uuniq, uidx = np.unique(users, return_inverse=True)
    iuniq, iidx = np.unique(items, return_inverse=True)
    return (uidx.astype(np.int64), iidx.astype(np.int64),
            arr[:, 2].astype(np.float32), arr[:, 3].astype(np.int64),
            uuniq, iuniq)


# ---------------------------------------------------------------------------
# OGB node-property raw layout (ogbn-*)
# ---------------------------------------------------------------------------


def _ogb_root(root: str, name: str) -> Optional[str]:
    dirname = name.replace("-", "_")
    for base in (os.path.join(root, dirname), root):
        if os.path.isdir(os.path.join(base, "raw")):
            return base
    return None


def has_ogb_raw(root: Optional[str], name: str) -> bool:
    if not root or not os.path.isdir(root):
        return False
    base = _ogb_root(root, name)
    return base is not None and _ogb_csv(base, "raw", "edge") is not None


def _ogb_csv(base: str, sub: str, stem: str) -> Optional[str]:
    for ext in (".csv.gz", ".csv"):
        p = os.path.join(base, sub, stem + ext)
        if os.path.exists(p):
            return p
    return None


def _load_csv(path: str, dtype):
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return np.loadtxt(f, delimiter=",", dtype=dtype, ndmin=2)


def parse_ogb_nodeprop(root: str, name: str):
    """Parse the OGB node-property on-disk layout without the ``ogb``
    package: ``raw/edge.csv.gz`` (src,dst rows), ``raw/node-feat.csv.gz``,
    ``raw/node-label.csv.gz``, ``raw/num-node-list.csv.gz`` and the
    ``split/<type>/{train,valid,test}.csv.gz`` index files — the exact
    files ``ogb.nodeproppred.NodePropPredDataset`` reads.

    Returns a dict with ``edge_index`` (2, E), ``num_nodes``,
    ``node_feat`` (or None), ``label`` and a ``split`` dict.
    """
    base = _ogb_root(root, name)
    if base is None:
        raise FileNotFoundError(f"no OGB raw layout for {name} under {root}")
    edges = _load_csv(_ogb_csv(base, "raw", "edge"), np.int64)
    out = {"edge_index": edges.T}
    p = _ogb_csv(base, "raw", "num-node-list")
    if p is not None:
        out["num_nodes"] = int(_load_csv(p, np.int64).ravel()[0])
    else:
        out["num_nodes"] = int(edges.max()) + 1
    p = _ogb_csv(base, "raw", "node-feat")
    out["node_feat"] = _load_csv(p, np.float32) if p else None
    p = _ogb_csv(base, "raw", "node-label")
    out["label"] = _load_csv(p, np.int64).ravel() if p else None
    split = {}
    split_root = os.path.join(base, "split")
    if os.path.isdir(split_root):
        types = sorted(
            d for d in os.listdir(split_root)
            if os.path.isdir(os.path.join(split_root, d))
        )
        if types:
            for key in ("train", "valid", "test"):
                p = _ogb_csv(base, os.path.join("split", types[0]), key)
                if p is not None:
                    split[key] = _load_csv(p, np.int64).ravel()
    out["split"] = split
    return out


# -- BitcoinOTC (reference ``data/bitcoinotc.py``: soc-sign-bitcoinotc.csv
#    "SOURCE,TARGET,RATING,TIME" rows, cumulative 14-day snapshots) ---------


def has_bitcoinotc_raw(raw_dir) -> bool:
    if not raw_dir:
        return False
    return any(
        os.path.exists(os.path.join(raw_dir, f))
        for f in ("soc-sign-bitcoinotc.csv", "soc-sign-bitcoinotc.csv.gz")
    )


def parse_bitcoinotc(raw_dir: str):
    """Returns (edges (E,2) int64 zero-based, rating (E,), time_index (E,))
    with the reference's 14-day cumulative snapshot indexing
    (``bitcoinotc.py:100-120``)."""
    import gzip

    path = os.path.join(raw_dir, "soc-sign-bitcoinotc.csv")
    if not os.path.exists(path):
        with gzip.open(path + ".gz", "rt") as f:
            data = np.loadtxt(f, delimiter=",")
    else:
        data = np.loadtxt(path, delimiter=",")
    data = np.atleast_2d(data)
    edges = data[:, 0:2].astype(np.int64)
    edges -= edges.min()
    rating = data[:, 2].astype(np.int64)
    delta = 14 * 24 * 3600.0
    t = data[:, 3]
    time_index = np.around((t - t.min()) / delta).astype(np.int64)
    return edges, rating, time_index


# -- temporal event KGs (reference ``data/icews18.py`` / ``gdelt.py``:
#    {mode}.txt TSV of [head, rel, tail, time] int rows) --------------------


def has_temporal_kg_raw(raw_dir, mode: str = "train") -> bool:
    return bool(raw_dir) and os.path.exists(
        os.path.join(raw_dir, f"{mode}.txt"))


def parse_temporal_kg(raw_dir: str, mode: str = "train",
                      time_divisor: float = 24.0):
    """Returns (src, rel, dst, time_index) int64 arrays. ``time_divisor``
    buckets raw times (hours/24 for ICEWS18 per ``icews18.py:99``;
    minutes/15 for GDELT per ``gdelt.py``)."""
    data = np.loadtxt(os.path.join(raw_dir, f"{mode}.txt"),
                      delimiter="\t").astype(np.int64)
    data = np.atleast_2d(data)
    time_index = np.floor(data[:, 3] / time_divisor).astype(np.int64)
    return data[:, 0], data[:, 1], data[:, 2], time_index


# -- fraud graphs (reference ``data/fraud.py``: YelpChi.mat / Amazon.mat
#    scipy .mat with sparse per-relation adjacency + features + label) ------

_FRAUD_FILES = {"yelp": "YelpChi.mat", "amazon": "Amazon.mat"}
_FRAUD_RELS = {
    "yelp": ["net_rsr", "net_rtr", "net_rur"],
    "amazon": ["net_upu", "net_usu", "net_uvu"],
}


def has_fraud_raw(raw_dir, name: str) -> bool:
    return bool(raw_dir) and os.path.exists(
        os.path.join(raw_dir, _FRAUD_FILES.get(name, "")))


def parse_fraud_mat(raw_dir: str, name: str):
    """Returns (relations dict etype -> (src, dst), features (N,F) f32,
    labels (N,) int64) from the reference's .mat layout
    (``fraud.py:118-140``)."""
    from scipy import io as sio
    import scipy.sparse as sp

    data = sio.loadmat(os.path.join(raw_dir, _FRAUD_FILES[name]))
    feats = data["features"]
    if sp.issparse(feats):
        feats = feats.todense()
    feats = np.asarray(feats, np.float32)
    labels = np.asarray(data["label"]).squeeze().astype(np.int64)
    rels = {}
    for et in _FRAUD_RELS[name]:
        coo = sp.coo_matrix(data[et])
        rels[et] = (coo.row.astype(np.int64), coo.col.astype(np.int64))
    return rels, feats, labels


def parse_ppi_dir(raw_dir: str, mode: str = "train"):
    """Parse the real PPI layout (reference ``data/ppi.py:73-92``, the
    GraphSAGE distribution): ``{mode}_graph.json`` (networkx node-link),
    ``{mode}_feats.npy`` (N, 50), ``{mode}_labels.npy`` (N, 121),
    ``{mode}_graph_id.npy`` (N,) splitting nodes into the 20/2/2
    component graphs. Returns (edges (2, E) over GLOBAL node ids,
    feats, labels, graph_id)."""
    import json as _json
    import os as _os

    with open(_os.path.join(raw_dir, f"{mode}_graph.json")) as f:
        nl = _json.load(f)
    id_of = {}
    for i, node in enumerate(nl["nodes"]):
        id_of[node["id"]] = i
    src = []
    dst = []
    for link in nl["links"]:
        src.append(id_of[link["source"]])
        dst.append(id_of[link["target"]])
    edges = np.asarray([src, dst], dtype=np.int64)
    feats = np.load(_os.path.join(raw_dir, f"{mode}_feats.npy"))
    labels = np.load(_os.path.join(raw_dir, f"{mode}_labels.npy"))
    graph_id = np.load(
        _os.path.join(raw_dir, f"{mode}_graph_id.npy")).astype(np.int64)
    return edges, feats.astype(np.float32), labels.astype(np.float32), \
        graph_id


def has_ppi_raw(raw_dir, mode: str = "train") -> bool:
    import os as _os

    return bool(raw_dir) and _os.path.exists(
        _os.path.join(raw_dir, f"{mode}_graph.json"))


def parse_superpixel_pkl(raw_dir: str, name: str = "MNIST",
                         split: str = "train", use_feature: bool = False):
    """Parse the benchmarking-gnns superpixel pickle (reference
    ``data/superpixel.py:150-154``): ``superpixels/{mnist_75sp|
    cifar10_150sp}_{split}.pkl`` holding ``(labels, sp_data)`` with
    ``sample[:2] = (mean_px (N, C), coord (N, 2))``. Rebuilds the
    gaussian-kernel kNN graph (sigma = mean of each node's 8 nearest
    distances; top-8 most-similar neighbors per node) and returns a list
    of ``(src, dst, node_feat (N, C+2), edge_feat (E,), label)``.
    """
    import os as _os
    import pickle as _pickle

    from scipy.spatial.distance import cdist

    img_size = 28 if name == "MNIST" else 32
    stem = "mnist_75sp" if name == "MNIST" else "cifar10_150sp"
    path = _os.path.join(raw_dir, "superpixels", f"{stem}_{split}.pkl")
    if not _os.path.exists(path):
        path = _os.path.join(raw_dir, f"{stem}_{split}.pkl")
    with open(path, "rb") as f:
        labels, sp_data = _pickle.load(f)

    def knn_sigma(d, kth=8):
        n = d.shape[0]
        if n - 1 <= kth:
            return np.ones((n, 1))
        nn = np.partition(d, kth, axis=-1)[:, : kth + 1]
        return nn.sum(axis=1, keepdims=True) / kth + 1e-8

    out = []
    for i, sample in enumerate(sp_data):
        mean_px, coord = sample[0], sample[1]
        coord = coord.reshape(-1, 2) / img_size
        n = coord.shape[0]
        mean_px = mean_px.reshape(n, -1)
        cd_ = cdist(coord, coord)
        A = -((cd_ / knn_sigma(cd_)) ** 2)
        if use_feature:
            fd = cdist(mean_px, mean_px)
            A = A - (fd / knn_sigma(fd)) ** 2
        A = np.exp(A)
        A = 0.5 * (A + A.T)
        np.fill_diagonal(A, 0)
        kth = 9
        src_l, dst_l, ev_l = [], [], []
        if n > kth:
            order = np.argpartition(A, n - kth - 1, axis=-1)[:, n - kth:-1]
            for u in range(n):
                for v in order[u]:
                    if v != u:
                        src_l.append(u)
                        dst_l.append(int(v))
                        ev_l.append(A[u, v])
        else:
            for u in range(n):
                for v in range(n):
                    if u != v or n == 1:
                        src_l.append(u)
                        dst_l.append(v)
                        ev_l.append(A[u, v])
        x = np.concatenate([mean_px, coord], axis=1).astype(np.float32)
        out.append((np.asarray(src_l, np.int64),
                    np.asarray(dst_l, np.int64), x,
                    np.asarray(ev_l, np.float32), int(labels[i])))
    return out


def has_superpixel_raw(raw_dir, name="MNIST", split="train") -> bool:
    import os as _os

    if not raw_dir:
        return False
    stem = "mnist_75sp" if name == "MNIST" else "cifar10_150sp"
    return (_os.path.exists(_os.path.join(raw_dir, "superpixels",
                                          f"{stem}_{split}.pkl"))
            or _os.path.exists(_os.path.join(raw_dir,
                                             f"{stem}_{split}.pkl")))


def _ptb_parse(line: str):
    """Parse one PTB s-expression ``(label child child ...)`` into a
    nested (label, children-or-word) tuple (reference ``data/tree.py``
    uses nltk.Tree.fromstring; this is a dependency-free reader)."""
    tokens = line.replace("(", " ( ").replace(")", " ) ").split()
    pos = 0

    def rec():
        nonlocal pos
        assert tokens[pos] == "(", tokens[pos]
        pos += 1
        label = int(tokens[pos])
        pos += 1
        children = []
        word = None
        while tokens[pos] != ")":
            if tokens[pos] == "(":
                children.append(rec())
            else:
                word = tokens[pos]
                pos += 1
        pos += 1
        return (label, children if children else word)

    return rec()


def parse_sst_trees(raw_dir: str, mode: str = "train",
                    vocab_file: str = None):
    """Parse the real SST layout (reference ``data/tree.py``): PTB trees
    in ``sst/{mode}.txt`` (one s-expression per line) + ``vocab.txt``
    (one token per line). Returns (trees, vocab) where each tree is
    (src, dst, x, y, mask) arrays in the reference's child->parent
    edge convention, x = word id or PAD (-1), mask = 1 on leaves."""
    import os as _os

    base = raw_dir
    if _os.path.isdir(_os.path.join(raw_dir, "sst")):
        base = _os.path.join(raw_dir, "sst")
    vf = vocab_file or _os.path.join(base, "vocab.txt")
    vocab = {}
    with open(vf, encoding="utf-8") as f:
        for i, tok in enumerate(f):
            vocab[tok.strip().lower()] = i
    trees = []
    with open(_os.path.join(base, f"{mode}.txt"), encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            root = _ptb_parse(line)
            src, dst, xs, ys, masks = [], [], [], [], []

            def add(label, payload, parent):
                nid = len(xs)
                if isinstance(payload, str):
                    xs.append(vocab.get(payload.lower(), -1))
                    masks.append(1)
                    ys.append(label)
                else:
                    xs.append(-1)
                    masks.append(0)
                    ys.append(label)
                if parent is not None:
                    src.append(nid)
                    dst.append(parent)
                if not isinstance(payload, str):
                    for ch in payload:
                        add(ch[0], ch[1], nid)
                return nid

            add(root[0], root[1], None)
            trees.append((np.asarray(src, np.int64),
                          np.asarray(dst, np.int64),
                          np.asarray(xs, np.int32),
                          np.asarray(ys, np.int32),
                          np.asarray(masks, np.int32)))
    return trees, vocab


def has_sst_raw(raw_dir, mode="train") -> bool:
    import os as _os

    if not raw_dir:
        return False
    return (_os.path.exists(_os.path.join(raw_dir, f"{mode}.txt"))
            or _os.path.exists(_os.path.join(raw_dir, "sst",
                                             f"{mode}.txt")))


def parse_fakenews_dir(raw_dir: str, feature_name: str = "profile"):
    """Parse the real FakeNews (UPFD) layout (reference
    ``data/fakenews.py:138-180``): ``A.txt`` comma edge list,
    ``node_graph_id.npy``, ``graph_labels.npy``,
    ``{train,val,test}_idx.npy``, ``new_{feature}_feature.npz`` (scipy
    sparse). Returns (src, dst, node_graph_id, graph_labels, splits,
    features)."""
    import os as _os

    import scipy.sparse as _sp

    edges = np.genfromtxt(_os.path.join(raw_dir, "A.txt"),
                          delimiter=",", dtype=np.int64)
    node_graph_id = np.load(
        _os.path.join(raw_dir, "node_graph_id.npy")).astype(np.int64)
    labels = np.load(_os.path.join(raw_dir, "graph_labels.npy"))
    splits = {
        k: np.load(_os.path.join(raw_dir, f"{k}_idx.npy"))
        for k in ("train", "val", "test")
    }
    feat = np.asarray(_sp.load_npz(
        _os.path.join(raw_dir, f"new_{feature_name}_feature.npz")
    ).todense(), dtype=np.float32)
    return (edges[:, 0], edges[:, 1], node_graph_id, labels, splits,
            feat)


def has_fakenews_raw(raw_dir) -> bool:
    import os as _os

    return bool(raw_dir) and _os.path.exists(
        _os.path.join(raw_dir, "A.txt")) and _os.path.exists(
        _os.path.join(raw_dir, "node_graph_id.npy"))


def parse_graphsaint_dir(raw_dir: str):
    """Parse the GraphSAINT distribution layout (reference
    ``data/flickr.py:89-110``, ``data/yelp.py``): ``adj_full.npz``
    (scipy CSR), ``feats.npy``, ``class_map.json`` (node id -> class or
    multilabel list), ``role.json`` ({tr, va, te} index lists).
    Returns (src, dst, feats, labels, masks{train,val,test})."""
    import json as _json
    import os as _os

    import scipy.sparse as _sp

    adj = _sp.load_npz(_os.path.join(raw_dir, "adj_full.npz")).tocoo()
    feats = np.load(_os.path.join(raw_dir, "feats.npy"))
    with open(_os.path.join(raw_dir, "class_map.json")) as f:
        class_map = _json.load(f)
    n = feats.shape[0]
    first = next(iter(class_map.values()))
    if isinstance(first, list):
        labels = np.zeros((n, len(first)), np.float32)
        for k, v in class_map.items():
            labels[int(k)] = v
    else:
        labels = np.zeros(n, np.int64)
        for k, v in class_map.items():
            labels[int(k)] = v
    with open(_os.path.join(raw_dir, "role.json")) as f:
        role = _json.load(f)
    masks = {}
    for key, name in (("tr", "train"), ("va", "val"), ("te", "test")):
        m = np.zeros(n, bool)
        m[np.asarray(role[key], np.int64)] = True
        masks[name] = m
    return (adj.row.astype(np.int64), adj.col.astype(np.int64),
            feats.astype(np.float32), labels, masks)


def has_graphsaint_raw(raw_dir) -> bool:
    import os as _os

    return bool(raw_dir) and _os.path.exists(
        _os.path.join(raw_dir, "adj_full.npz"))


def parse_wikics_json(raw_dir: str):
    """Parse the real WikiCS ``data.json`` (reference
    ``data/wikics.py:91-116``): features/labels/links + per-split mask
    matrices. Returns (src, dst, feats, labels, masks)."""
    import json as _json
    import os as _os

    with open(_os.path.join(raw_dir, "data.json")) as f:
        data = _json.load(f)
    feats = np.asarray(data["features"], np.float32)
    labels = np.asarray(data["labels"], np.int64)
    src, dst = [], []
    for i, js in enumerate(data["links"]):
        for j in js:
            src.append(i)
            dst.append(j)
    masks = {
        "train_mask": np.asarray(data["train_masks"], bool).T,
        "val_mask": np.asarray(data["val_masks"], bool).T,
        "stopping_mask": np.asarray(data["stopping_masks"], bool).T,
        "test_mask": np.asarray(data["test_mask"], bool),
    }
    return (np.asarray(src, np.int64), np.asarray(dst, np.int64),
            feats, labels, masks)


def has_wikics_raw(raw_dir) -> bool:
    import os as _os

    return bool(raw_dir) and _os.path.exists(
        _os.path.join(raw_dir, "data.json"))


def parse_geom_gcn_dir(raw_dir: str, name: str):
    """Parse the geom-gcn raw layout (reference ``data/geom_gcn.py:43-90``
    — chameleon/squirrel/actor/cornell/texas/wisconsin):
    ``out1_node_feature_label.txt`` (id<TAB>f1,f2,...<TAB>label with a
    header line), ``out1_graph_edges.txt`` (dst<TAB>src with header),
    and ten ``{name}_split_0.6_0.2_{i}.npz`` mask files. Returns
    (src, dst, feats, labels, train/val/test mask stacks (N, 10))."""
    import os as _os

    feat_rows, label_vals = [], []
    with open(_os.path.join(raw_dir,
                            "out1_node_feature_label.txt")) as f:
        next(f)  # header: node_id<TAB>feature<TAB>label
        for line in f:
            line = line.strip()
            if not line:
                continue
            _nid, feat_csv, label = line.split("\t")
            feat_rows.append(
                np.fromiter((float(v) for v in feat_csv.split(",")),
                            dtype=np.float32))
            label_vals.append(int(label))
    feats = np.stack(feat_rows)
    labels = np.asarray(label_vals, np.int64)
    edges = np.loadtxt(_os.path.join(raw_dir, "out1_graph_edges.txt"),
                       dtype=np.int64, skiprows=1, ndmin=2)
    dst, src = edges[:, 0], edges[:, 1]
    tr, va, te = [], [], []
    for i in range(10):
        path = _os.path.join(raw_dir,
                             f"{name}_split_0.6_0.2_{i}.npz")
        if not _os.path.exists(path):
            break
        z = np.load(path)
        tr.append(z["train_mask"].astype(bool))
        va.append(z["val_mask"].astype(bool))
        te.append(z["test_mask"].astype(bool))
    masks = (np.stack(tr, 1), np.stack(va, 1), np.stack(te, 1)) \
        if tr else (None, None, None)
    return src, dst, feats, labels, masks


def has_geom_gcn_raw(raw_dir) -> bool:
    import os as _os

    return bool(raw_dir) and _os.path.exists(
        _os.path.join(raw_dir, "out1_graph_edges.txt"))


def parse_sbm_pkl(raw_dir: str, name: str = "PATTERN",
                  mode: str = "train"):
    """Parse the benchmarking-gnns SBM pickle (``SBM_PATTERN.pkl`` /
    ``SBM_CLUSTER.pkl`` — the public distribution behind the graphs the
    reference re-serializes as DGL ``.bin``, reference
    ``data/pattern.py:91``, ``data/cluster.py``): a pickled 3-tuple/list
    of (train, val, test) sample lists; each sample carries a dense
    adjacency ``W`` (n, n), integer ``node_feat`` (n,) and
    ``node_label`` (n,) — as dict keys or attributes, torch tensors or
    numpy.

    Returns a list of (src, dst, node_feat, node_label) per graph.
    """
    import os as _os
    import pickle as _pickle

    path = _os.path.join(raw_dir, f"SBM_{name.upper()}.pkl")
    with open(path, "rb") as f:
        splits = _pickle.load(f)
    split = splits[{"train": 0, "valid": 1, "val": 1, "test": 2}[mode]]

    def _field(sample, key):
        v = sample[key] if isinstance(sample, dict) else getattr(sample,
                                                                 key)
        return np.asarray(v)

    out = []
    for sample in split:
        W = _field(sample, "W")
        src, dst = np.nonzero(W)
        out.append((src.astype(np.int64), dst.astype(np.int64),
                    _field(sample, "node_feat").astype(np.int64).ravel(),
                    _field(sample, "node_label").astype(np.int64).ravel()))
    return out


def has_sbm_raw(raw_dir, name: str = "PATTERN") -> bool:
    import os as _os

    return bool(raw_dir) and _os.path.exists(
        _os.path.join(raw_dir, f"SBM_{name.upper()}.pkl"))


# periodic-table subset covering peptide/organic SMILES
_ATOMIC_NUM = {
    "H": 1, "B": 5, "C": 6, "N": 7, "O": 8, "F": 9, "Si": 14, "P": 15,
    "S": 16, "Cl": 17, "Se": 34, "Br": 35, "I": 53,
}
_BOND_ORDER = {"-": 1, "=": 2, "#": 3, ":": 1, "/": 1, "\\": 1}


def smiles_to_graph(smiles: str):
    """Minimal dependency-free SMILES reader: atoms (incl. bracket
    atoms with charge/H-count), bonds (- = # : / \\), branches, ring
    closures (digits + %nn), aromatic lowercase.

    NOT an rdkit replacement: node features are
    ``[atomic_num, aromatic, formal_charge + 4, ring_member]`` int64 and
    edge features ``[bond_order, aromatic_bond]`` — a documented
    divergence from ogb's 9-dim atom embedding (the reference's
    ``smiles2graph`` needs rdkit, unavailable here; reference
    ``data/lrgb.py:192``). Returns (src, dst, node_feat, edge_feat)
    with both edge directions.
    """
    atoms = []    # [atomic_num, aromatic, charge+4, ring]
    bonds = []    # (u, v, order, aromatic)
    prev = None
    stack = []
    rings = {}
    pending_bond = None
    i, n = 0, len(smiles)

    def add_atom(sym, aromatic, charge):
        atoms.append([_ATOMIC_NUM[sym], int(aromatic), charge + 4, 0])
        return len(atoms) - 1

    while i < n:
        ch = smiles[i]
        if ch == "(":
            stack.append(prev)
            i += 1
        elif ch == ")":
            prev = stack.pop()
            i += 1
        elif ch in "-=#:/\\":
            pending_bond = ch
            i += 1
        elif ch == ".":
            prev = None
            i += 1
        elif ch == "[":
            j = smiles.index("]", i)
            body = smiles[i + 1:j]
            k = 0
            while k < len(body) and body[k].isdigit():  # isotope
                k += 1
            sym = body[k]
            if k + 1 < len(body) and body[k:k + 2] in _ATOMIC_NUM:
                sym = body[k:k + 2]
            aromatic = sym.islower()
            charge = body.count("+") - body.count("-")
            a = add_atom(sym.capitalize() if len(sym) == 1 else sym,
                         aromatic, charge)
            if prev is not None:
                o = _BOND_ORDER.get(pending_bond, 1)
                bonds.append((prev, a, o, 0))
            pending_bond, prev = None, a
            i = j + 1
        elif ch.isdigit() or ch == "%":
            if ch == "%":
                num = smiles[i + 1:i + 3]
                i += 3
            else:
                num = ch
                i += 1
            if num in rings:
                u = rings.pop(num)
                o = _BOND_ORDER.get(pending_bond, 1)
                arom = int(smiles[i - len(num) - 1].islower()
                           if i - len(num) - 1 >= 0 else 0)
                bonds.append((u, prev, o, arom))
                atoms[u][3] = 1
                atoms[prev][3] = 1
            else:
                rings[num] = prev
            pending_bond = None
        else:
            sym = ch
            if i + 1 < n and smiles[i:i + 2] in ("Cl", "Br", "Si", "Se"):
                sym = smiles[i:i + 2]
                i += 2
            elif ch.upper() in _ATOMIC_NUM or ch in "cnops":
                i += 1
            else:  # unsupported token (stereo @, H counts outside [])
                i += 1
                continue
            aromatic = sym.islower()
            a = add_atom(sym if len(sym) == 2 else sym.upper(), aromatic,
                         0)
            if prev is not None:
                o = _BOND_ORDER.get(pending_bond,
                                    1)
                bonds.append((prev, a, o,
                              int(aromatic and atoms[prev][1])))
            pending_bond, prev = None, a

    node_feat = np.asarray(atoms, np.int64)
    if bonds:
        u = np.asarray([b[0] for b in bonds], np.int64)
        v = np.asarray([b[1] for b in bonds], np.int64)
        ef = np.asarray([[b[2], b[3]] for b in bonds], np.int64)
        src = np.concatenate([u, v])
        dst = np.concatenate([v, u])
        edge_feat = np.concatenate([ef, ef])
    else:
        src = dst = np.zeros(0, np.int64)
        edge_feat = np.zeros((0, 2), np.int64)
    return src, dst, node_feat, edge_feat


def parse_lrgb_peptides(raw_dir: str, name: str = "Peptides-struct"):
    """Parse the LRGB peptides CSV (reference ``data/lrgb.py:145,408``:
    ``peptide_structure_dataset.csv.gz`` with 11 regression targets /
    ``peptide_multi_class_dataset.csv.gz`` with ``labels`` lists).
    SMILES strings become graphs via :func:`smiles_to_graph`.

    Returns (graphs, targets): graphs a list of
    (src, dst, node_feat, edge_feat), targets (B, T) float32.
    """
    import csv as _csv
    import gzip as _gzip
    import os as _os

    struct = "struct" in name.lower()
    fname = ("peptide_structure_dataset.csv.gz" if struct
             else "peptide_multi_class_dataset.csv.gz")
    path = _os.path.join(raw_dir, fname)
    opener = _gzip.open if fname.endswith(".gz") else open
    if not _os.path.exists(path):
        path = path[: -len(".gz")]
        opener = open
    target_names = [
        "Inertia_mass_a", "Inertia_mass_b", "Inertia_mass_c",
        "Inertia_valence_a", "Inertia_valence_b", "Inertia_valence_c",
        "length_a", "length_b", "length_c", "Spherocity",
        "Plane_best_fit",
    ]
    graphs, targets = [], []
    with opener(path, "rt") as f:
        for row in _csv.DictReader(f):
            graphs.append(smiles_to_graph(row["smiles"]))
            if struct:
                targets.append([float(row[t]) for t in target_names])
            else:
                lab = [int(x) for x in
                       row["labels"].strip("[] ").replace(",", " ").split()]
                hot = np.zeros(10, np.float32)
                hot[lab] = 1.0
                targets.append(hot)
    t = np.asarray(targets, np.float32)
    if struct and len(t):
        # the reference normalizes targets to zero mean / unit std
        t = (t - t.mean(0)) / np.maximum(t.std(0), 1e-9)
    return graphs, t


def has_lrgb_raw(raw_dir, name: str = "Peptides-struct") -> bool:
    import os as _os

    if not raw_dir:
        return False
    stem = ("peptide_structure_dataset.csv"
            if "struct" in name.lower() else
            "peptide_multi_class_dataset.csv")
    return (_os.path.exists(_os.path.join(raw_dir, stem + ".gz"))
            or _os.path.exists(_os.path.join(raw_dir, stem)))
