"""Dataset utilities (counterpart of ``dgl_tpu/data/utils.py``; reference
``python/dgl/data/utils.py``, ``superpixel.py:30-75``,
``knowledge_graph.py:276``).

Host work is numpy, as in the JAX package; masks and graphs lie on
``device`` (``"cuda"`` unless the caller asks for the CPU). ``to_tensor``
gives a frame the port's dtypes: bool masks, float32 values and int64
integers (labels and ids, as ``F.cross_entropy`` takes them)."""
from __future__ import annotations

import hashlib
import os
import warnings
from typing import Optional

import numpy as np
import torch

__all__ = [
    "idx2mask",
    "generate_mask_tensor",
    "Subset",
    "add_nodepred_split",
    "add_node_property_split",
    "eliminate_self_loops",
    "build_knowledge_graph",
    "compute_adjacency_matrix_images",
    "compute_edges_list",
    "check_sha1",
    "check_local_file_exists",
    "is_local_path",
    "check_pytorch",
    "deprecate_function",
    "deprecate_class",
    "deprecate_property",
    "load_data",
    "load_cora",
    "load_citeseer",
    "load_pubmed",
]


def to_tensor(x, device, dtype=None) -> torch.Tensor:
    """A host array as a frame tensor on ``device``: ``dtype``, or by the
    array's kind bool, int64 (any integer) or float32 (any float), the
    values the JAX package keeps. One copy to the device."""
    a = np.asarray(x)
    if dtype is None:
        kind = a.dtype.kind
        dtype = (torch.bool if kind == "b" else torch.int64 if kind in "iu"
                 else torch.float32 if kind == "f" else None)
        if dtype is None:
            raise TypeError(f"no frame dtype for a {a.dtype} array")
    host = torch.from_numpy(np.ascontiguousarray(a))
    return host.to(dtype).to(device)


def idx2mask(idx, len):  # noqa: A002 - reference signature
    """Index array -> 0/1 mask (reference ``data/utils.py:382``)."""
    mask = np.zeros(len)
    mask[np.asarray(idx)] = 1
    return mask


def generate_mask_tensor(mask, device="cuda"):
    """numpy mask -> bool tensor on ``device`` (reference
    ``data/utils.py:389``)."""
    assert isinstance(mask, np.ndarray), \
        "input for generate_mask_tensor should be an numpy ndarray"
    return to_tensor(mask, device, torch.bool)


class Subset:
    """Index-view of a dataset (reference ``data/utils.py:407``)."""

    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(np.asarray(indices).tolist())

    def __getitem__(self, item):
        return self.dataset[self.indices[item]]

    def __len__(self):
        return len(self.indices)


def add_nodepred_split(dataset, ratio, ntype=None, seed: Optional[int] = None):
    """Add train/val/test node masks to every graph (reference
    ``data/utils.py:445``)."""
    if len(ratio) != 3:
        raise ValueError(
            f"Split ratio must be a float triplet but got {ratio}."
        )
    rng = np.random.default_rng(seed)
    for i in range(len(dataset)):
        g = dataset[i]
        n = g.num_nodes(ntype)
        idx = rng.permutation(n)
        n_train = int(n * ratio[0])
        n_val = int(n * ratio[1])
        frame = g._node_frames.setdefault(
            ntype or (g.ntypes[0] if len(g.ntypes) == 1 else None), {}
        )
        frame["train_mask"] = generate_mask_tensor(
            idx2mask(idx[:n_train], n), g.device)
        frame["val_mask"] = generate_mask_tensor(
            idx2mask(idx[n_train:n_train + n_val], n), g.device
        )
        frame["test_mask"] = generate_mask_tensor(
            idx2mask(idx[n_train + n_val:], n), g.device
        )


def _property_popularity(g):
    return g.in_degrees().cpu().numpy().astype(np.float64)


def _property_density(g):
    # local clustering-coefficient proxy: triangles / possible pairs over
    # the undirected 1-hop neighborhood
    import scipy.sparse as sp

    src, dst = (a.cpu().numpy() for a in g.edges())
    n = g.num_nodes()
    A = sp.coo_matrix(
        (np.ones(src.shape[0]), (src, dst)), shape=(n, n)
    ).tocsr()
    A = ((A + A.T) > 0).astype(np.float64)
    tri = np.asarray((A @ A).multiply(A).sum(axis=1)).ravel() / 2.0
    deg = np.asarray(A.sum(axis=1)).ravel()
    denom = np.maximum(deg * (deg - 1) / 2.0, 1.0)
    return tri / denom


def _property_locality(g, seed=0):
    # personalized-pagerank mass concentration from a random seed node
    import scipy.sparse as sp

    src, dst = (a.cpu().numpy() for a in g.edges())
    n = g.num_nodes()
    A = sp.coo_matrix(
        (np.ones(src.shape[0]), (src, dst)), shape=(n, n)
    ).tocsr()
    deg = np.maximum(np.asarray(A.sum(axis=1)).ravel(), 1.0)
    P = sp.diags(1.0 / deg) @ A
    rng = np.random.default_rng(seed)
    r = np.zeros(n)
    r[rng.integers(n)] = 1.0
    x = r.copy()
    for _ in range(20):
        x = 0.15 * r + 0.85 * (P.T @ x)
    return x


_PROPERTY_FNS = {
    "popularity": _property_popularity,
    "density": _property_density,
    "locality": _property_locality,
}


def add_node_property_split(dataset, part_ratios, property_name,
                            ascending: bool = True,
                            random_seed: Optional[int] = None):
    """Distribution-shift node split by a structural property (reference
    ``data/utils.py:574``, arXiv:2302.13875): sorts nodes by the property
    and cuts 5 parts — in_train/in_valid/in_test/out_valid/out_test."""
    assert property_name in _PROPERTY_FNS, \
        "property must be 'popularity', 'locality', or 'density'"
    assert len(part_ratios) == 5, "part_ratios must contain 5 values"
    rng = np.random.default_rng(random_seed)
    names = [
        "in_train_mask", "in_valid_mask", "in_test_mask",
        "out_valid_mask", "out_test_mask",
    ]
    for i in range(len(dataset)):
        g = dataset[i]
        vals = _PROPERTY_FNS[property_name](g)
        if not ascending:
            vals = -vals
        n = g.num_nodes()
        jitter = rng.permutation(n) / (10.0 * n)  # tie-break randomly
        order = np.argsort(vals + jitter, kind="stable")
        bounds = np.cumsum(
            [0] + [int(r * n) for r in part_ratios[:-1]] + [n]
        )[:6]
        bounds[5] = n
        nt = g.ntypes[0] if len(g.ntypes) == 1 else None
        frame = g._node_frames.setdefault(nt, {})
        for k, name in enumerate(names):
            frame[name] = generate_mask_tensor(
                idx2mask(order[bounds[k]:bounds[k + 1]], n), g.device
            )


def eliminate_self_loops(A):
    """Zero the diagonal of a scipy sparse matrix (reference
    ``data/citation_graph.py`` _eliminate_self_loops)."""
    A = A.tolil()
    A.setdiag(0)
    return A.tocsr()


def build_knowledge_graph(num_nodes, num_rels, train, valid, test,
                          create_reverse: bool = True, device="cuda"):
    """Assemble a hetero KG from (src, rel, dst) triple arrays (reference
    ``data/knowledge_graph.py:276`` build_knowledge_graph): one etype per
    relation id, optional reverse relations; on ``device``."""
    from .. import convert

    data_dict = {}
    for split in (train, valid, test):
        if split is None or len(split) == 0:
            continue
        arr = np.asarray(split)
        for r in np.unique(arr[:, 1]):
            sel = arr[arr[:, 1] == r]
            key = ("node", f"rel_{int(r)}", "node")
            s, d = sel[:, 0], sel[:, 2]
            if key in data_dict:
                s = np.concatenate([data_dict[key][0], s])
                d = np.concatenate([data_dict[key][1], d])
            data_dict[key] = (s, d)
            if create_reverse:
                rkey = ("node", f"rel_{int(r)}_inv", "node")
                rs, rd = sel[:, 2], sel[:, 0]
                if rkey in data_dict:
                    rs = np.concatenate([data_dict[rkey][0], rs])
                    rd = np.concatenate([data_dict[rkey][1], rd])
                data_dict[rkey] = (rs, rd)
    return convert.heterograph(
        data_dict, num_nodes_dict={"node": int(num_nodes)}, device=device
    )


def _sigma(d):
    return d.mean() + 1e-8


def compute_adjacency_matrix_images(coord, feat, use_feat: bool = True):
    """Gaussian-kernel adjacency over superpixel coordinates (reference
    ``data/superpixel.py:30``)."""
    from scipy.spatial.distance import cdist

    coord = np.asarray(coord).reshape(-1, 2)
    c_dist = cdist(coord, coord)
    if use_feat:
        f_dist = cdist(np.asarray(feat), np.asarray(feat))
        A = np.exp(
            -((c_dist / _sigma(c_dist)) ** 2)
            - (f_dist / _sigma(f_dist)) ** 2
        )
    else:
        A = np.exp(-((c_dist / _sigma(c_dist)) ** 2))
    A = 0.5 * (A + A.T)
    A[np.diag_indices_from(A)] = 0
    return A


def compute_edges_list(A, kth: int = 9):
    """Top-k similar neighbors per node from a dense adjacency (reference
    ``data/superpixel.py:51``)."""
    A = np.asarray(A)
    num_nodes = A.shape[0]
    new_kth = num_nodes - kth
    if num_nodes > kth:
        knns = np.argpartition(A, new_kth - 1, axis=-1)[:, new_kth:-1]
        knn_values = np.partition(A, new_kth - 1, axis=-1)[:, new_kth:-1]
    else:
        knns = np.tile(np.arange(num_nodes), num_nodes).reshape(
            num_nodes, num_nodes
        )
        knn_values = A
        if num_nodes != 1:
            knn_values = A[knns != np.arange(num_nodes)[:, None]].reshape(
                num_nodes, -1
            )
            knns = knns[knns != np.arange(num_nodes)[:, None]].reshape(
                num_nodes, -1
            )
    return knns, knn_values


def check_sha1(filename: str, sha1_hash: str) -> bool:
    """(reference ``data/utils.py`` check_sha1)."""
    h = hashlib.sha1()
    with open(filename, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest() == sha1_hash


def is_local_path(path: str) -> bool:
    """(reference ``data/utils.py``): not a URL."""
    return not (
        str(path).startswith("http://")
        or str(path).startswith("https://")
        or str(path).startswith("s3://")
    )


def check_local_file_exists(path: str) -> bool:
    return is_local_path(path) and os.path.exists(path)


def check_pytorch():
    """The reference asserts the torch backend; the port is PyTorch, so
    there is nothing to check."""


def deprecate_function(func, old_name: str, new_name: str):
    """(reference ``data/utils.py`` deprecate_function)."""

    def wrapper(*args, **kwargs):
        warnings.warn(
            f"{old_name} is deprecated; use {new_name}.", DeprecationWarning
        )
        return func(*args, **kwargs)

    return wrapper


def deprecate_class(new_class, old_name: str):
    """(reference ``data/utils.py`` deprecate_class)."""

    class _Deprecated(new_class):
        def __init__(self, *args, **kwargs):
            warnings.warn(
                f"{old_name} is deprecated; use {new_class.__name__}.",
                DeprecationWarning,
            )
            super().__init__(*args, **kwargs)

    _Deprecated.__name__ = old_name
    return _Deprecated


def deprecate_property(prop, old_name: str, new_name: str):
    """(reference ``data/utils.py`` deprecate_property)."""

    def getter(self):
        warnings.warn(
            f"{old_name} is deprecated; use {new_name}.", DeprecationWarning
        )
        return prop.fget(self)

    return property(getter)


# -- legacy functional citation loaders (reference
#    ``data/citation_graph.py:700+`` load_cora/load_citeseer/load_pubmed) ----


def load_cora(raw_dir=None, device="cuda"):
    from .citation import CoraGraphDataset

    return CoraGraphDataset(raw_dir=raw_dir, device=device)


def load_citeseer(raw_dir=None, device="cuda"):
    from .citation import CiteseerGraphDataset

    return CiteseerGraphDataset(raw_dir=raw_dir, device=device)


def load_pubmed(raw_dir=None, device="cuda"):
    from .citation import PubmedGraphDataset

    return PubmedGraphDataset(raw_dir=raw_dir, device=device)


def load_data(args, device="cuda"):
    """Dispatch by ``args.dataset`` name (reference examples'
    ``load_data``)."""
    name = args if isinstance(args, str) else getattr(args, "dataset")
    name = name.lower()
    if name == "cora":
        return load_cora(device=device)
    if name == "citeseer":
        return load_citeseer(device=device)
    if name == "pubmed":
        return load_pubmed(device=device)
    if name == "reddit":
        from .synthetic import RedditDataset

        return RedditDataset(device=device)
    raise ValueError(f"unknown dataset {name!r}")


def makedirs(path: str):
    """mkdir -p (reference ``data/utils.py`` makedirs)."""
    os.makedirs(os.path.expanduser(os.path.normpath(path)), exist_ok=True)


def loadtxt(path, delimiter, dtype=None):
    """Fast csv/tsv numeric loader (reference ``data/utils.py`` loadtxt:
    pandas fast path with numpy fallback)."""
    try:
        import pandas as pd

        return pd.read_csv(path, delimiter=delimiter, header=None).values
    except ImportError:
        return np.loadtxt(path, delimiter=delimiter, dtype=dtype)


def sigma(dists):
    """Mean-distance bandwidth for gaussian adjacency (reference
    ``data/superpixel.py`` sigma)."""
    return np.asarray(dists).mean() + 1e-8


def sbm(n_blocks, block_size, p, q, rng=None):
    """Symmetric stochastic block model adjacency (reference
    ``data/sbm.py:16``); returns a scipy sparse matrix."""
    import scipy.sparse as sp

    n = n_blocks * block_size
    p = p / n
    q = q / n
    rng = np.random.RandomState() if rng is None else rng
    rows, cols = [], []
    for i in range(n_blocks):
        for j in range(i, n_blocks):
            density = p if i == j else q
            block = sp.random(
                block_size, block_size, density,
                random_state=rng, data_rvs=lambda m: np.ones(m),
            ).tocoo()
            rows.append(block.row + i * block_size)
            cols.append(block.col + j * block_size)
    rows = np.concatenate(rows)
    cols = np.concatenate(cols)
    a = sp.coo_matrix(
        (np.ones(rows.shape[0]), (rows, cols)), shape=(n, n)
    )
    adj = a + a.T  # symmetrize
    adj.data[:] = 1
    return adj.tocsr()


def _calc_redundancy(k, num_edges, num_pairs, r=3):
    # expected over-sampling factor so that after dedup/rejection we still
    # have k negatives (reference ``data/adapter.py`` _calc_redundancy)
    p = num_edges / num_pairs
    return (1 + r * p) / max(1 - p, 1e-6)


def negative_sample(g, num_samples, seed=None):
    """Sample negative (non-)edges, excluding self loops (reference
    ``data/adapter.py:207``)."""
    num_nodes = g.num_nodes()
    redundancy = _calc_redundancy(
        num_samples, g.num_edges(), num_nodes ** 2
    )
    sample_size = int(num_samples * (1 + redundancy))
    rng = np.random.default_rng(seed)
    edges = rng.integers(0, num_nodes, size=(2, sample_size))
    edges = np.unique(edges, axis=1)
    mask_self = edges[0] == edges[1]
    has = g.has_edges_between(edges[0], edges[1]).cpu().numpy()
    edges = edges[:, ~(mask_self | has)]
    return edges[:, :num_samples]


def mask_nodes_by_property(property_values, part_ratios, random_seed=None,
                           device="cuda"):
    """5-way ID/OOD masks by sorted property (reference
    ``data/utils.py`` mask_nodes_by_property); returns a dict of bool
    tensors on ``device``."""
    assert len(part_ratios) == 5
    vals = np.asarray(property_values, dtype=np.float64)
    n = vals.shape[0]
    rng = np.random.default_rng(random_seed)
    jitter = rng.permutation(n) / (10.0 * n)
    order = np.argsort(vals + jitter, kind="stable")
    bounds = np.concatenate(
        [[0], np.cumsum([int(r * n) for r in part_ratios[:-1]]), [n]]
    )
    names = ["in_train_mask", "in_valid_mask", "in_test_mask",
             "out_valid_mask", "out_test_mask"]
    return {
        name: generate_mask_tensor(
            idx2mask(order[bounds[k]:bounds[k + 1]], n), device
        )
        for k, name in enumerate(names)
    }


def tensor_dict_to_ndarray_dict(tensor_dict):
    """(reference ``data/heterograph_serialize.py:14``)."""
    return {k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
            else np.asarray(v) for k, v in tensor_dict.items()}


def save_heterographs(filename, g_list, labels=None, formats=None):
    """Save heterographs (reference ``heterograph_serialize.py:22``); the
    npz container already handles hetero graphs, so this is the same
    writer (``formats`` accepted for parity — layouts are rebuilt eagerly
    on load)."""
    from .serialize import save_graphs

    return save_graphs(filename, g_list, labels)


def load_yaml_with_sanity_check(yaml_file: str):
    """Parse and validate a CSVDataset meta file (reference
    ``data/csv_dataset_base.py:52``). Reads JSON, the same schema, and
    imports ``yaml`` only for a file that is not JSON."""
    import json as _json

    from .csv_dataset import MetaYaml

    with open(yaml_file) as f:
        text = f.read()
    try:
        meta = _json.loads(text)
    except _json.JSONDecodeError:
        try:
            import yaml

            meta = yaml.safe_load(text)
        except ImportError as e:
            raise ValueError(
                "meta file is not JSON and pyyaml is unavailable"
            ) from e
    if "dataset_name" not in meta:
        raise ValueError("meta file must define dataset_name")
    return MetaYaml(**meta)


__all__ += [
    "makedirs", "loadtxt", "sigma", "sbm", "negative_sample",
    "mask_nodes_by_property", "tensor_dict_to_ndarray_dict",
    "save_heterographs", "load_yaml_with_sanity_check",
]
