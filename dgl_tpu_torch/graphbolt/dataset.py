"""Dataset/Task abstractions (counterpart of ``dgl_tpu/graphbolt/dataset.py``;
reference ``python/dgl/graphbolt/dataset.py``)."""
from __future__ import annotations

from typing import Dict, List

__all__ = ["Task", "Dataset"]


class Task:
    """Meta information + train/validation/test sets (reference
    ``dataset.py:15``)."""

    @property
    def metadata(self) -> Dict:
        raise NotImplementedError

    @property
    def train_set(self):
        raise NotImplementedError

    @property
    def validation_set(self):
        raise NotImplementedError

    @property
    def test_set(self):
        raise NotImplementedError


class Dataset:
    """Tasks + feature store + sampling-graph topology (reference
    ``dataset.py:50``)."""

    @property
    def tasks(self) -> List[Task]:
        raise NotImplementedError

    @property
    def graph(self):
        raise NotImplementedError

    @property
    def feature(self):
        raise NotImplementedError

    @property
    def dataset_name(self) -> str:
        raise NotImplementedError

    @property
    def all_nodes_set(self):
        raise NotImplementedError
