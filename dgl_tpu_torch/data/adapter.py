"""Dataset adapters (counterpart of ``dgl_tpu/data/adapter.py``; reference
``python/dgl/data/adapter.py``: AsNodePredDataset, AsLinkPredDataset,
AsGraphPredDataset + the OGB bridge).

Wraps any graph source (a DGLDataset, a raw Graph, or — when the ``ogb``
package is importable — an OGB dataset object) into the task-specific
interface the training pipelines expect. An adapter's masks lie on its
source graph's device; ``from_ogb`` builds on ``device``."""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from ..base import DGLError
from .dgl_dataset import DGLDataset
from .utils import to_tensor

__all__ = ["AsNodePredDataset", "AsLinkPredDataset", "AsGraphPredDataset",
           "from_ogb"]


def _get_graph(source):
    from ..graph import Graph

    if isinstance(source, Graph):
        return source
    if hasattr(source, "__getitem__"):
        return source[0]
    raise DGLError(f"cannot extract a graph from {type(source)}")


class AsNodePredDataset(DGLDataset):
    """(reference ``adapter.py`` AsNodePredDataset): ensures
    train/val/test masks exist with the requested split ratio."""

    def __init__(self, source, split_ratio: Sequence[float] = (0.8, 0.1, 0.1),
                 target_ntype: Optional[str] = None, seed: int = 0, **kwargs):
        self._source = source
        self.split_ratio = tuple(split_ratio)
        self.target_ntype = target_ntype
        self._seed = seed
        super().__init__(name="as-nodepred",
                         device=_get_graph(source).device)

    def process(self):
        g = _get_graph(self._source)
        nt = self.target_ntype or (
            g.ntypes[0] if len(g.ntypes) == 1 else None
        )
        frame = g._node_frames.setdefault(nt, {})
        if "train_mask" not in frame:
            n = g.num_nodes(nt)
            rng = np.random.default_rng(self._seed)
            perm = rng.permutation(n)
            n_tr = int(n * self.split_ratio[0])
            n_va = int(n * self.split_ratio[1])
            for key, sl in (
                ("train_mask", perm[:n_tr]),
                ("val_mask", perm[n_tr : n_tr + n_va]),
                ("test_mask", perm[n_tr + n_va :]),
            ):
                m = np.zeros(n, bool)
                m[sl] = True
                frame[key] = to_tensor(m, g.device)
        self._g = g
        labels = frame.get("label")
        self.num_classes = (
            int(labels.max()) + 1 if labels is not None else 0
        )

    def __getitem__(self, idx):
        assert idx == 0
        return self._g

    def __len__(self):
        return 1


class AsLinkPredDataset(DGLDataset):
    """(reference AsLinkPredDataset): splits edges into train/val/test with
    sampled negatives for eval."""

    def __init__(self, source, split_ratio=(0.8, 0.1, 0.1), neg_ratio=1,
                 seed=0, **kwargs):
        self._source = source
        self.split_ratio = tuple(split_ratio)
        self.neg_ratio = neg_ratio
        self._seed = seed
        super().__init__(name="as-linkpred",
                         device=_get_graph(source).device)

    def process(self):
        from ..sampling import global_uniform_negative_sampling
        from ..transforms.functional import remove_edges

        g = _get_graph(self._source)
        E = g.num_edges()
        rng = np.random.default_rng(self._seed)
        perm = rng.permutation(E)
        n_tr = int(E * self.split_ratio[0])
        n_va = int(E * self.split_ratio[1])
        rel = g._relation(None)
        src, dst = (a[:E] for a in rel.host_arrays("src", "dst"))

        def pairs(ids):
            return np.stack([src[ids], dst[ids]], 1)

        self.val_edges = pairs(perm[n_tr : n_tr + n_va])
        self.test_edges = pairs(perm[n_tr + n_va :])
        ns, nd = global_uniform_negative_sampling(
            g, (n_va + (E - n_tr - n_va)) * self.neg_ratio, seed=self._seed
        )
        ns, nd = ns.cpu().numpy(), nd.cpu().numpy()
        k = ns.shape[0] // 2
        self.val_neg_edges = np.stack([ns[:k], nd[:k]], 1)
        self.test_neg_edges = np.stack([ns[k:], nd[k:]], 1)
        # train graph excludes val/test edges (no leakage)
        self._g = remove_edges(g, perm[n_tr:])

    @property
    def train_graph(self):
        return self._g

    def __getitem__(self, idx):
        assert idx == 0
        return self._g

    def __len__(self):
        return 1


class AsGraphPredDataset(DGLDataset):
    """(reference AsGraphPredDataset): multi-graph dataset with split idx."""

    def __init__(self, source, split_ratio=(0.8, 0.1, 0.1), seed=0, **kwargs):
        self._source = source
        self.split_ratio = tuple(split_ratio)
        self._seed = seed
        super().__init__(name="as-graphpred",
                         device=getattr(source, "device", "cuda"))

    def process(self):
        n = len(self._source)
        rng = np.random.default_rng(self._seed)
        perm = rng.permutation(n)
        n_tr = int(n * self.split_ratio[0])
        n_va = int(n * self.split_ratio[1])
        self.train_idx = perm[:n_tr]
        self.val_idx = perm[n_tr : n_tr + n_va]
        self.test_idx = perm[n_tr + n_va :]

    def __getitem__(self, idx):
        return self._source[idx]

    def __len__(self):
        return len(self._source)


def _build_ogb_graph(edge_index, num_nodes, node_feat, labels, split,
                     device):
    from .. import convert

    src, dst = edge_index
    g = convert.graph((src, dst), num_nodes=num_nodes, device=device)
    if node_feat is not None:
        g.ndata["feat"] = to_tensor(node_feat, device)
    if labels is not None:
        g.ndata["label"] = to_tensor(np.asarray(labels).squeeze(), device)
    n = g.num_nodes()
    for key, split_key in (
        ("train_mask", "train"), ("val_mask", "valid"), ("test_mask", "test")
    ):
        if split_key not in split:
            continue
        m = np.zeros(n, bool)
        m[np.asarray(split[split_key])] = True
        g.ndata[key] = to_tensor(m, device)
    return g


def from_ogb(name: str, root: Optional[str] = None, device="cuda"):
    """OGB bridge (reference ``data/adapter.py`` DglNodePropPredDataset
    use). Two routes:

    1. the ``ogb`` package, when importable (handles downloads);
    2. a zero-egress parser over OGB's on-disk raw layout
       (``raw/edge.csv.gz`` etc.) via :func:`parsers.parse_ogb_nodeprop`
       for pre-populated data directories.

    The graph and its frames lie on ``device``.
    """
    try:
        from ogb.nodeproppred import NodePropPredDataset  # type: ignore
    except ImportError:
        NodePropPredDataset = None
    if NodePropPredDataset is not None:
        ds = NodePropPredDataset(name, root=root)
        graph_obj, labels = ds[0]
        return _build_ogb_graph(
            graph_obj["edge_index"], graph_obj["num_nodes"],
            graph_obj.get("node_feat"), labels, ds.get_idx_split(), device,
        )
    from .parsers import has_ogb_raw, parse_ogb_nodeprop

    if root is not None and has_ogb_raw(root, name):
        d = parse_ogb_nodeprop(root, name)
        return _build_ogb_graph(
            d["edge_index"], d["num_nodes"], d["node_feat"], d["label"],
            d["split"], device,
        )
    raise DGLError(
        "the `ogb` package is not installed and no OGB raw layout was "
        f"found under root={root!r}; either pre-populate the raw csv.gz "
        "layout or use the dgl_tpu_torch.data synthetic datasets"
    )
