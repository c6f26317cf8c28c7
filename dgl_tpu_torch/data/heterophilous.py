"""Heterophilous graph suite (counterpart of
``dgl_tpu/data/heterophilous.py``; reference
``python/dgl/data/heterophilous_graphs.py``, arXiv:2302.11640:
roman-empire, amazon-ratings, minesweeper, tolokers, questions).

Real parser: the published format is one ``<name>.npz`` with keys
``edges`` (E, 2), ``node_features``, ``node_labels``, ``train_masks`` /
``val_masks`` / ``test_masks`` (10, N). Zero-egress fallback: a
low-homophily synthetic graph calibrated to the published statistics
(same policy as the citation stand-ins, ``data/citation.py``). The graph
and its frames lie on ``device``; labels are int64.
"""
from __future__ import annotations

import os
from typing import Optional

import zlib

import numpy as np
import torch

from .dgl_dataset import DGLDataset
from .synthetic import synthetic_classification_graph
from .utils import to_tensor

__all__ = [
    "HeterophilousGraphDataset",
    "RomanEmpireDataset",
    "AmazonRatingsDataset",
    "MinesweeperDataset",
    "TolokersDataset",
    "QuestionsDataset",
]

# published statistics (paper table 1): nodes, edges, feat dim, classes
_STATS = {
    "roman_empire": (22662, 32927, 300, 18),
    "amazon_ratings": (24492, 93050, 300, 5),
    "minesweeper": (10000, 39402, 7, 2),
    "tolokers": (11758, 519000, 10, 2),
    "questions": (48921, 153540, 301, 2),
}


class HeterophilousGraphDataset(DGLDataset):
    """(reference ``heterophilous_graphs.py:15``)."""

    def __init__(self, name: str, raw_dir: Optional[str] = None,
                 force_reload: bool = False, verbose: bool = False,
                 transform=None, device="cuda"):
        name = name.lower().replace("-", "_")
        if name not in _STATS:
            raise ValueError(
                f"unknown heterophilous dataset {name!r}; options "
                f"{sorted(_STATS)}"
            )
        self._real_dir = raw_dir
        super().__init__(name=name, raw_dir=raw_dir, transform=transform,
                         device=device)

    def _npz_path(self):
        if self._real_dir is None:
            return None
        for p in (
            os.path.join(self._real_dir, f"{self.name}.npz"),
            os.path.join(self._real_dir, self.name, f"{self.name}.npz"),
        ):
            if os.path.exists(p):
                return p
        return None

    def process(self):
        from .. import convert
        from ..transforms.functional import to_bidirected

        n, e, d, c = _STATS[self.name]
        device = self.device
        self._num_classes = c
        path = self._npz_path()
        if path is not None:
            data = np.load(path)
            src = data["edges"][:, 0]
            dst = data["edges"][:, 1]
            feat = data["node_features"]
            labels = data["node_labels"]
            g = convert.graph(
                (src, dst), num_nodes=int(labels.shape[0]), device=device
            )
            g = to_bidirected(g)
            g.ndata["feat"] = to_tensor(feat, device, torch.float32)
            g.ndata["label"] = to_tensor(labels.astype(np.int32), device)
            # (10, N) mask sets -> (N, 10), reference transposes the same
            for key, out in (
                ("train_masks", "train_mask"),
                ("val_masks", "val_mask"),
                ("test_masks", "test_mask"),
            ):
                g.ndata[out] = to_tensor(data[key].T.astype(bool), device)
            self._num_classes = int(np.unique(labels).shape[0])
            self._g = g
            return
        # calibrated synthetic stand-in: LOW homophily is the point of
        # this suite
        g = synthetic_classification_graph(
            n, e, c, d, homophily=0.25,
            seed=zlib.crc32(self.name.encode()) % 2**31, device=device,
        )
        self._g = g

    def __getitem__(self, idx):
        assert idx == 0
        return self._apply_transform(self._g)

    def __len__(self):
        return 1

    @property
    def num_classes(self):
        return self._num_classes


def _named(name, cls_name):
    class _D(HeterophilousGraphDataset):
        def __init__(self, raw_dir=None, force_reload=False, verbose=False,
                     transform=None, device="cuda", **kwargs):
            super().__init__(
                name, raw_dir=raw_dir, force_reload=force_reload,
                verbose=verbose, transform=transform, device=device,
            )

    _D.__name__ = cls_name
    return _D


RomanEmpireDataset = _named("roman-empire", "RomanEmpireDataset")
AmazonRatingsDataset = _named("amazon-ratings", "AmazonRatingsDataset")
MinesweeperDataset = _named("minesweeper", "MinesweeperDataset")
TolokersDataset = _named("tolokers", "TolokersDataset")
QuestionsDataset = _named("questions", "QuestionsDataset")
