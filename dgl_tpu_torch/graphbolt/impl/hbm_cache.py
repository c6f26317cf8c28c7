"""Device-resident hot-feature cache (counterpart of
``dgl_tpu/graphbolt/impl/hbm_cache.py``; the role of the reference's
GPUCache: ``python/dgl/cuda/gpu_cache.py:24``,
``graphbolt/src/cuda/extension/gpu_cache.cu``).

For minibatch training whose feature table does not fit on the card, keep
the hottest rows (by degree: on power-law graphs the top-degree rows serve
most lookups) in device memory; each batch's input ids split into

  hits   -> one gather from the resident table on the card
  misses -> a host read of just those rows (memory, mmap or batched
            pread) and one upload from a pinned buffer

The hot set is chosen once from the degrees, so the device table never
churns and the split is one ``searchsorted`` on the host. The rows are
put in place with index copies on the card; the reference pads the hit
and miss counts to buckets of 256 so that XLA compiles once, which eager
PyTorch does not need, so the port does no bucketing (the rows, their
order and the hit and miss counts are the reference's). Host-RAM caching
below this tier is :class:`~dgl_tpu_torch.graphbolt.CachedFeature`.
"""
from __future__ import annotations

import numpy as np
import torch

from ...graph import _asnumpy
from ..feature_store import Feature
from .feature_stores import _ids_on, _upload

__all__ = ["HBMFeatureCache"]


class HBMFeatureCache(Feature):
    """Two-tier feature fetch: hot rows on ``device`` (default ``"cuda"``)
    and a host fallback.

    ``fallback``: any host Feature (NumpyFeature, DiskBasedFeature, ...).
    ``hot_ids``: node ids to keep on the device (e.g. top-degree; see
    :meth:`from_degrees`). Reads return tensors on ``device``.
    """

    def __init__(self, fallback, hot_ids: np.ndarray, device="cuda"):
        self._fb = fallback
        self.device = torch.device(device)
        hot = np.unique(_asnumpy(hot_ids).astype(np.int64))
        self._hot_sorted = hot
        self._table = _upload(_asnumpy(fallback.read(hot)), self.device)
        self.hits = 0
        self.misses = 0

    @classmethod
    def from_degrees(cls, fallback, degrees: np.ndarray, capacity: int,
                     device="cuda"):
        """Keep the ``capacity`` highest-degree rows (GPUCache's admission
        by access frequency, computed statically from the graph)."""
        hot = np.argpartition(-_asnumpy(degrees), capacity - 1)[:capacity]
        return cls(fallback, hot, device)

    @property
    def capacity(self) -> int:
        return self._hot_sorted.shape[0]

    def hit_rate(self) -> float:
        t = self.hits + self.misses
        return self.hits / t if t else 0.0

    def split(self, ids: np.ndarray):
        """Host-side split of a batch: (hit_pos, hit_slots, miss_pos,
        miss_ids). ``hit_slots`` index the device table."""
        ids = _asnumpy(ids)
        slot = np.searchsorted(self._hot_sorted, ids)
        slot_c = np.clip(slot, 0, self._hot_sorted.shape[0] - 1)
        hit = self._hot_sorted[slot_c] == ids
        self.hits += int(hit.sum())
        self.misses += int(ids.size - hit.sum())
        return (np.nonzero(hit)[0], slot_c[hit],
                np.nonzero(~hit)[0], ids[~hit])

    def read_batch(self, ids: np.ndarray) -> torch.Tensor:
        """The (len(ids), F) rows on the device: hot rows gathered from the
        resident table, misses read on the host (only those rows cross to
        the card) and copied into place."""
        hit_pos, hit_slots, miss_pos, miss_ids = self.split(ids)
        table = self._table
        out = torch.empty((hit_pos.shape[0] + miss_pos.shape[0],)
                          + tuple(table.shape[1:]), dtype=table.dtype,
                          device=self.device)
        if hit_pos.size:
            out.index_copy_(0, _ids_on(hit_pos, self.device),
                            table.index_select(
                                0, _ids_on(hit_slots, self.device)))
        if miss_ids.size:
            rows = _upload(_asnumpy(self._fb.read(miss_ids)), self.device)
            out.index_copy_(0, _ids_on(miss_pos, self.device),
                            rows.to(table.dtype))
        return out

    # the Feature API, so the cache drops into FeatureStore slots
    def read(self, ids=None):
        if ids is None:
            return self._fb.read()
        return self.read_batch(ids)

    def size(self):
        return self._fb.size()

    def count(self):
        return self._fb.count()
