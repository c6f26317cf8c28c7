"""Partition book (counterpart of
``dgl_tpu/distributed/graph_partition_book.py``; reference
``python/dgl/distributed/graph_partition_book.py:541``
``RangePartitionBook``): global id <-> (part, local id) over contiguous
ranges, on the host."""
from __future__ import annotations

from typing import Optional

import numpy as np

__all__ = ["RangePartitionBook"]


class RangePartitionBook:
    """Nodes relabelled so part ``p`` owns the global ids
    ``[ranges[p], ranges[p + 1])``."""

    def __init__(self, node_ranges, num_parts: int,
                 meta: Optional[dict] = None):
        self._ranges = np.asarray(node_ranges, dtype=np.int64)
        self._num_parts = int(num_parts)
        self.meta = meta or {}

    @property
    def num_partitions(self) -> int:
        return self._num_parts

    def nid2partid(self, nids):
        """(reference ``graph_partition_book.py:787``)."""
        return np.searchsorted(self._ranges, np.asarray(nids),
                               side="right") - 1

    def nid2localnid(self, nids, partid):
        return np.asarray(nids) - self._ranges[partid]

    def partid2nids(self, partid):
        return np.arange(self._ranges[partid], self._ranges[partid + 1])

    def metadata(self):
        return [{"num_nodes": int(self._ranges[p + 1] - self._ranges[p])}
                for p in range(self._num_parts)]

    def num_nodes(self, partid=None):
        if partid is None:
            return int(self._ranges[-1])
        return int(self._ranges[partid + 1] - self._ranges[partid])

    @property
    def partid(self):
        from .dist_context import get_rank

        return get_rank()
