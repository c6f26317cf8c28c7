"""Feature-store implementations under the reference's names (counterpart
of ``dgl_tpu/graphbolt/impl/feature_stores.py``; reference
``python/dgl/graphbolt/impl/torch_based_feature_store.py``,
``basic_feature_store.py``, ``cpu_cached_feature.py:19,465``,
``cpu_feature_cache.py:14``, ``gpu_cached_feature.py:261``).

``TorchBasedFeature`` keeps a CPU tensor and reads tensors. The GPU cache
is a static hot-row table in device memory (``GPUFeatureCache``): the role
of the reference's HugeCTR GPU cache, chosen once (for instance by degree)
rather than churned, so a read is one gather on the card for the hits and
one upload of the misses from a pinned buffer.
"""
from __future__ import annotations

from collections import namedtuple
from typing import Optional

import numpy as np
import torch

from ...graph import _asnumpy
from ..feature_store import (
    Feature,
    FeatureStore,
    NumpyFeature,
    cache_policies,
)

__all__ = [
    "BasicFeatureStore",
    "TorchBasedFeature",
    "TorchBasedFeatureStore",
    "FeatureKey",
    "get_feature_key_list",
    "CPUFeatureCache",
    "CPUCachedFeature",
    "cpu_cached_feature",
    "DeviceCachedFeature",
    "GPUCachedFeature",
    "gpu_cached_feature",
    "GPUFeatureCache",
    "wrap_with_cached_feature",
]

FeatureKey = namedtuple("FeatureKey", ["domain", "type", "name"])


def get_feature_key_list(feature_store) -> list:
    """All keys of a store as FeatureKey tuples (reference
    ``feature_store.py`` get_feature_key_list)."""
    return [FeatureKey(*k) for k in feature_store.keys()]


class BasicFeatureStore(FeatureStore):
    """Dict-of-features store with (domain, type, name) keys (reference
    ``impl/basic_feature_store.py``)."""


class TorchBasedFeature(Feature):
    """Feature backed by a CPU tensor (reference
    ``impl/torch_based_feature_store.py`` TorchBasedFeature). Reads return
    CPU tensors."""

    def __init__(self, tensor, metadata: Optional[dict] = None):
        if not isinstance(tensor, torch.Tensor):
            raise TypeError("expected a torch.Tensor")
        self._t = tensor.cpu()
        self._metadata = metadata or {}

    def read(self, ids=None):
        if ids is None:
            return self._t
        idx = torch.from_numpy(_asnumpy(ids).astype(np.int64))
        return torch.index_select(self._t, 0, idx)

    def size(self):
        return tuple(self._t.shape[1:])

    def count(self):
        return self._t.shape[0]

    def update(self, value, ids=None):
        value = torch.as_tensor(_asnumpy(value))
        if ids is None:
            self._t = value
        else:
            self._t[torch.from_numpy(_asnumpy(ids).astype(np.int64))] = value

    def metadata(self):
        return dict(self._metadata)


class TorchBasedFeatureStore(BasicFeatureStore):
    """Store built from OnDiskFeatureData descriptors (reference
    ``impl/torch_based_feature_store.py`` TorchBasedFeatureStore): each
    entry names (domain, type, name, path/tensor)."""

    def __init__(self, feat_data):
        super().__init__()

        def field(spec, key, default=None):
            # specs may be OnDiskFeatureData dataclasses OR plain dicts;
            # dataclass attributes can legitimately be None
            if isinstance(spec, dict):
                return spec.get(key, default)
            val = getattr(spec, key, None)
            return default if val is None else val

        for spec in feat_data or []:
            domain = field(spec, "domain")
            type_ = field(spec, "type", "_N")
            name = field(spec, "name")
            source = field(spec, "path")
            if domain is None or name is None:
                raise ValueError(f"feature spec needs domain+name: {spec}")
            if hasattr(domain, "value"):
                domain = domain.value  # OnDiskFeatureDataDomain enum
            if source is not None:
                arr = np.load(source, mmap_mode="r")
                feat = NumpyFeature(np.asarray(arr))
            else:
                tensor = field(spec, "tensor")
                if tensor is None:
                    raise ValueError(
                        f"feature spec needs a path or tensor: {spec}"
                    )
                feat = (
                    TorchBasedFeature(tensor)
                    if isinstance(tensor, torch.Tensor)
                    else NumpyFeature(tensor)
                )
            self[(domain, type_, name)] = feat


class CPUFeatureCache:
    """Standalone host-RAM cache backend (reference
    ``impl/cpu_feature_cache.py:14``): policy + row buffer, shareable
    between multiple :class:`CPUCachedFeature` via id offsets."""

    def __init__(self, shape, dtype, policy: str = "sieve"):
        capacity = int(shape[0])
        if policy not in cache_policies:
            raise ValueError(
                f"unknown policy {policy!r}; options {list(cache_policies)}"
            )
        self._policy = cache_policies[policy](capacity)
        self._buf = np.zeros(tuple(shape), dtype=dtype)
        self.capacity = capacity
        self.hits = 0
        self.misses = 0

    def query(self, keys: np.ndarray):
        """(values, missing_index, missing_keys): rows for hits, positions
        and keys of misses (reference CPUFeatureCache.query)."""
        keys = _asnumpy(keys)
        out = np.zeros((keys.shape[0],) + self._buf.shape[1:],
                       self._buf.dtype)
        miss_index, miss_keys = [], []
        for i, key in enumerate(keys.tolist()):
            slot = self._policy.lookup(key)
            if slot is None:
                self.misses += 1
                miss_index.append(i)
                miss_keys.append(key)
            else:
                self.hits += 1
                out[i] = self._buf[slot]
        return (
            out,
            np.asarray(miss_index, dtype=np.int64),
            np.asarray(miss_keys, dtype=np.int64),
        )

    def replace(self, keys: np.ndarray, values: np.ndarray):
        """Admit rows for the given keys (reference
        CPUFeatureCache.replace)."""
        keys = _asnumpy(keys)
        for j, key in enumerate(keys.tolist()):
            slot = self._policy.lookup(key)
            if slot is None:
                slot, _ = self._policy.insert(key)
            self._buf[slot] = values[j]


class CPUCachedFeature(Feature):
    """Cache-backed feature with the reference ctor
    ``(fallback_feature, cache, offset)`` (reference
    ``impl/cpu_cached_feature.py:19``)."""

    _cache_type = CPUFeatureCache

    def __init__(self, fallback_feature: Feature, cache: CPUFeatureCache,
                 offset: int = 0):
        self._fallback = fallback_feature
        self._cache = cache
        self._offset = int(offset)

    def read(self, ids=None):
        if ids is None:
            return self._fallback.read()
        ids = _asnumpy(ids).astype(np.int64)
        vals, miss_index, miss_keys = self._cache.query(ids + self._offset)
        if miss_index.size:
            fetched = _asnumpy(
                self._fallback.read(miss_keys - self._offset)
            )
            vals[miss_index] = fetched
            self._cache.replace(miss_keys, fetched)
        return vals

    def size(self):
        return self._fallback.size()

    def count(self):
        return self._fallback.count()

    def update(self, value, ids=None):
        self._fallback.update(value, ids)

    @property
    def cache(self):
        return self._cache

    @property
    def hit_rate(self):
        total = self._cache.hits + self._cache.misses
        return self._cache.hits / total if total else 0.0


def cpu_cached_feature(fallback_feature: Feature,
                       max_cache_size_in_bytes: int,
                       policy: str = "sieve",
                       pin_memory: bool = False) -> CPUCachedFeature:
    """Byte-budgeted constructor (reference
    ``impl/cpu_cached_feature.py:465``); ``pin_memory`` is accepted for
    the reference's signature (the cache's rows are read on the host)."""
    row_shape = tuple(fallback_feature.size())
    probe = _asnumpy(fallback_feature.read(np.array([0])))
    row_bytes = max(probe.nbytes, 1)
    capacity = max(int(max_cache_size_in_bytes // row_bytes), 1)
    cache = CPUFeatureCache((capacity,) + row_shape, probe.dtype,
                            policy=policy)
    return CPUCachedFeature(fallback_feature, cache)


def _upload(rows: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host rows as a tensor on ``device``: to the card from a pinned
    staging buffer (asynchronous on the current stream; the pinned block
    is not reused before the copy completes), on the CPU as they are."""
    t = torch.from_numpy(np.ascontiguousarray(rows))
    if device.type != "cuda":
        return t.to(device)
    staged = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    staged.copy_(t)
    return staged.to(device, non_blocking=True)


def _ids_on(a: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.int64)).to(device)


class GPUFeatureCache:
    """Device-resident static hot-row cache backend: a table of the hottest
    rows on ``device`` (default ``"cuda"``) and a host id -> slot map,
    decided at construction (for instance by degree order). The reference's
    mutable GPU hash cache (``gpu_cached_feature.py``, HugeCTR) becomes a
    fixed hot set, as in ``dgl_tpu``."""

    def __init__(self, hot_ids: np.ndarray, rows, device="cuda"):
        self.hot_ids = _asnumpy(hot_ids).astype(np.int64)
        self.device = torch.device(device)
        self.table = _upload(_asnumpy(rows), self.device)
        n = int(self.hot_ids.max()) + 1 if self.hot_ids.size else 0
        self._slot = np.full(n, -1, dtype=np.int64)
        self._slot[self.hot_ids] = np.arange(self.hot_ids.shape[0])

    def slots_of(self, ids: np.ndarray) -> np.ndarray:
        ids = _asnumpy(ids).astype(np.int64)
        safe = np.where(ids < self._slot.shape[0], ids, 0)
        slots = np.where(
            ids < self._slot.shape[0], self._slot[safe], -1
        )
        return slots


class DeviceCachedFeature(Feature):
    """Feature whose hottest rows live in device memory (reference
    ``impl/gpu_cached_feature.py`` GPUCachedFeature): one gather on the
    device for the cached rows, a host read of the cold tail and one
    upload of just those rows, each put in place by index."""

    def __init__(self, fallback_feature: Feature, cache: GPUFeatureCache):
        self._fallback = fallback_feature
        self._cache = cache
        self.hits = 0
        self.misses = 0

    @classmethod
    def from_hot_ids(cls, fallback_feature: Feature, hot_ids,
                     device="cuda"):
        hot_ids = _asnumpy(hot_ids).astype(np.int64)
        rows = _asnumpy(fallback_feature.read(hot_ids))
        return cls(fallback_feature, GPUFeatureCache(hot_ids, rows, device))

    def read(self, ids=None):
        cache = self._cache
        if ids is None:
            return _upload(_asnumpy(self._fallback.read()), cache.device)
        ids = _asnumpy(ids).astype(np.int64)
        slots = cache.slots_of(ids)
        hit = slots >= 0
        self.hits += int(hit.sum())
        self.misses += int((~hit).sum())
        out = torch.empty((ids.shape[0],) + tuple(cache.table.shape[1:]),
                          dtype=cache.table.dtype, device=cache.device)
        hit_pos = np.nonzero(hit)[0]
        if hit_pos.size:
            out[_ids_on(hit_pos, cache.device)] = cache.table.index_select(
                0, _ids_on(slots[hit], cache.device))
        if hit_pos.size < ids.shape[0]:
            cold = _upload(_asnumpy(self._fallback.read(ids[~hit])),
                           cache.device)
            out[_ids_on(np.nonzero(~hit)[0], cache.device)] = cold.to(
                out.dtype)
        return out

    def size(self):
        return self._fallback.size()

    def count(self):
        return self._fallback.count()

    @property
    def hit_rate(self):
        total = self.hits + self.misses
        return self.hits / total if total else 0.0


# Reference name.
GPUCachedFeature = DeviceCachedFeature


def gpu_cached_feature(fallback_feature: Feature,
                       max_cache_size_in_bytes: int,
                       device="cuda") -> DeviceCachedFeature:
    """Byte-budgeted device-cache constructor (reference
    ``impl/gpu_cached_feature.py:261``). The hot set is the first-N rows
    by id — callers with degree information should pass explicit
    ``hot_ids`` to :meth:`DeviceCachedFeature.from_hot_ids`."""
    probe = _asnumpy(fallback_feature.read(np.array([0])))
    row_bytes = max(probe.nbytes, 1)
    capacity = max(int(max_cache_size_in_bytes // row_bytes), 1)
    capacity = min(capacity, fallback_feature.count())
    return DeviceCachedFeature.from_hot_ids(
        fallback_feature, np.arange(capacity), device
    )


def wrap_with_cached_feature(features, device: bool = False,
                             max_cache_size_in_bytes: int = 0,
                             policy: str = "sieve"):
    """Wrap one feature or a dict of features with a cache (reference
    ``impl/cpu_cached_feature.py`` wrap_with_cached_feature): with
    ``device``, a device cache on ``"cuda"``."""

    def one(f):
        if device:
            return gpu_cached_feature(f, max_cache_size_in_bytes)
        return cpu_cached_feature(f, max_cache_size_in_bytes, policy=policy)

    if isinstance(features, dict):
        return {k: one(v) for k, v in features.items()}
    return one(features)


class ParquetFeature(Feature):
    """Feature backed by a parquet file (the role of the reference's
    on-disk npy store, ``graphbolt/src/cnumpy.h``, for columnar data
    lakes; ``pyarrow`` is imported when one is opened). 2-D features
    are stored as a FixedSizeList column ``data``; reads memory-map the
    file and gather rows with arrow ``take`` (no full materialization)."""

    def __init__(self, path: str, column: str = "data"):
        import pyarrow.parquet as pq

        self._table = pq.read_table(path, memory_map=True)
        self._column = column
        col = self._table.column(column)
        self._width = (
            col.type.list_size
            if hasattr(col.type, "list_size") else None
        )

    @staticmethod
    def write(path: str, array, column: str = "data"):
        """Materialize an array as a parquet feature file."""
        import pyarrow as pa
        import pyarrow.parquet as pq

        array = _asnumpy(array)
        if array.ndim == 1:
            table = pa.table({column: pa.array(array)})
        elif array.ndim == 2:
            flat = pa.array(array.reshape(-1))
            col = pa.FixedSizeListArray.from_arrays(flat, array.shape[1])
            table = pa.table({column: col})
        else:
            raise ValueError("ParquetFeature stores 1-D or 2-D arrays")
        pq.write_table(table, path)
        return path

    def _to_numpy(self, chunked):
        import pyarrow as pa

        arr = chunked.combine_chunks() if hasattr(
            chunked, "combine_chunks"
        ) else chunked
        if isinstance(arr, pa.ChunkedArray):
            arr = arr.combine_chunks()
        if self._width is not None:
            return np.asarray(arr.flatten()).reshape(-1, self._width)
        return np.asarray(arr)

    def read(self, ids=None):
        col = self._table.column(self._column)
        if ids is None:
            return self._to_numpy(col)
        import pyarrow.compute as pc

        taken = pc.take(col, _asnumpy(ids).astype(np.int64))
        return self._to_numpy(taken)

    def size(self):
        return (self._width,) if self._width is not None else ()

    def count(self):
        return self._table.num_rows


__all__.append("ParquetFeature")
