"""Feature stores (counterpart of ``dgl_tpu/graphbolt/feature_store.py``;
reference ``python/dgl/graphbolt/feature_store.py:139``,
``impl/torch_based_feature_store.py``, C++ ``graphbolt/src/cnumpy.cc``
io_uring OnDiskNpyArray, ``cache_policy.h`` caches).

- ``NumpyFeature``: an in-RAM array.
- ``DiskBasedFeature``: an .npy file read row by row with parallel
  ``pread`` calls (``csrc/host_ops.cpp``'s ``batched_pread`` through
  ``_host.py``; the io_uring role), or through ``np.memmap`` when the
  caller asks for ``io="mmap"``.
- ``CachedFeature``: a host-RAM cache in front of any feature, with
  S3-FIFO, SIEVE, LRU or Clock eviction.
"""
from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np

from .. import _host
from ..base import DGLError
from ..graph import _asnumpy
from .impl.cache_policy import (
    CachePolicy,
    ClockPolicy,
    LRUPolicy,
    S3FifoPolicy,
    SievePolicy,
)

__all__ = [
    "Feature",
    "NumpyFeature",
    "DiskBasedFeature",
    "CachedFeature",
    "FeatureStore",
    "cache_policies",
]

# the pread path's block reads: about 64 KiB a block, 256 blocks (16 MiB)
# a buffer, taken when the blocks carry at most _DENSE times the bytes
# asked
_BLOCK_BYTES = 1 << 16
_BLOCK_CHUNK = 256
_DENSE = 8

cache_policies = {
    "s3-fifo": S3FifoPolicy,
    "sieve": SievePolicy,
    "lru": LRUPolicy,
    "clock": ClockPolicy,
}


class Feature:
    """Abstract feature (reference ``feature_store.py:38``)."""

    def read(self, ids=None):
        raise NotImplementedError

    def size(self) -> Tuple[int, ...]:
        raise NotImplementedError

    def count(self) -> int:
        raise NotImplementedError

    def update(self, value, ids=None):
        raise DGLError("read-only feature")


class NumpyFeature(Feature):
    """(reference TorchBasedFeature, ``impl/torch_based_feature_store.py``)."""

    def __init__(self, array):
        self._a = _asnumpy(array)

    def read(self, ids=None):
        if ids is None:
            return self._a
        return self._a[_asnumpy(ids)]

    def size(self):
        return tuple(self._a.shape[1:])

    def count(self):
        return self._a.shape[0]

    def update(self, value, ids=None):
        if ids is None:
            self._a = _asnumpy(value)
        else:
            self._a[_asnumpy(ids)] = _asnumpy(value)


def _npy_layout(path: str):
    """(shape, dtype, data offset) of an .npy file, from its header alone
    (the file is not mapped)."""
    with open(path, "rb") as f:
        version = np.lib.format.read_magic(f)
        if version == (1, 0):
            shape, fortran, dtype = np.lib.format.read_array_header_1_0(f)
        else:
            shape, fortran, dtype = np.lib.format.read_array_header_2_0(f)
        offset = f.tell()
    if fortran or len(shape) < 1 or dtype.hasobject:
        raise DGLError(f"DiskBasedFeature needs a C-ordered .npy of at "
                       f"least one dimension: {path}")
    return tuple(shape), dtype, offset


class DiskBasedFeature(Feature):
    """Out-of-core .npy feature (reference ``impl/ondisk_dataset`` +
    ``cnumpy.h`` io_uring OnDiskNpyArray).

    Two read paths:

    - ``io="pread"`` (the default, also for ``io=None``): parallel
      ``pread`` calls straight from the file descriptor
      (``_host.batched_pread``, built at first use; a failed build raises).
      The file is never mapped, so the process's resident memory stays
      bounded by the output buffers and a 16 MiB block buffer however far
      the table grows past RAM. A read whose rows lie dense in the file
      (the blocks of about 64 KiB that hold them carry at most
      ``_DENSE`` times the bytes asked) reads those blocks, one ``pread``
      each, and takes its rows from them: a ``pread`` call costs about as
      much as copying several KiB, so reading one a row costs more than
      reading whole blocks once many rows share them.
    - ``io="mmap"``, when the caller asks for it: ``np.memmap`` fancy
      indexing.

    ``read_async(ids)`` returns a ``concurrent.futures.Future``, so the
    caller can overlap feature I/O with sampling and compute (reference
    ``feature_fetcher.py:49`` read_async). ``close()`` releases the file
    and the thread pool.
    """

    def __init__(self, path: str, io: Optional[str] = None,
                 num_async_workers: int = 2):
        io = "pread" if io is None else io
        if io not in ("pread", "mmap"):
            raise DGLError(f"io must be 'pread' or 'mmap', got {io!r}")
        self._path = path
        self._io = io
        self._pool = None
        self._nworkers = num_async_workers
        self._fd = None
        if io == "mmap":
            self._a = np.load(path, mmap_mode="r")
            if self._a.ndim < 1 or not self._a.flags["C_CONTIGUOUS"]:
                raise DGLError("DiskBasedFeature needs a C-contiguous .npy")
            self._shape, self._dtype = self._a.shape, self._a.dtype
        else:
            self._shape, self._dtype, self._offset0 = _npy_layout(path)
            self._row_bytes = int(np.prod(self._shape[1:], dtype=np.int64)
                                  * self._dtype.itemsize)
            self._fd = os.open(path, os.O_RDONLY)

    def read(self, ids=None):
        if ids is None:
            if self._io == "mmap":
                return np.asarray(self._a)
            return np.fromfile(self._path, self._dtype,
                               offset=self._offset0).reshape(self._shape)
        ids = _asnumpy(ids)
        if self._io == "mmap":
            # fancy-index a memmap -> materialized copy of just those rows
            return np.asarray(self._a[ids])
        ids = ids.astype(np.int64).reshape(-1)
        out = np.empty((ids.shape[0],) + tuple(self._shape[1:]), self._dtype)
        if self._row_bytes == 0:
            return out
        raw = out.reshape(-1).view(np.uint8)
        per = max(1, _BLOCK_BYTES // self._row_bytes)  # rows a block
        blk = ids // per
        whole = blk < self._shape[0] // per  # the last block may be short
        blocks = np.unique(blk[whole])
        if blocks.shape[0] * per > _DENSE * ids.shape[0]:
            self._pread(ids, self._row_bytes, raw)
            return out
        # rows as single items: numpy moves them a memcpy each
        row = np.dtype((np.void, self._row_bytes))
        rows = raw.view(row)
        tail = np.nonzero(~whole)[0]
        if tail.size:
            rows[tail] = self._pread(ids[tail], self._row_bytes).reshape(
                -1).view(row)
        pos = np.nonzero(whole)[0]
        # each row's place in the read blocks, grouped by buffer (a radix
        # sort where the buffer numbers fit 16 bits)
        at = np.searchsorted(blocks, blk[pos]) * per + ids[pos] % per
        buf_of = at // (_BLOCK_CHUNK * per)
        order = np.argsort(buf_of.astype(np.uint16) if blocks.shape[0]
                           < _BLOCK_CHUNK << 16 else buf_of, kind="stable")
        pos, at = pos[order], at[order]
        ends = np.searchsorted(buf_of[order], np.arange(
            1, -(-blocks.shape[0] // _BLOCK_CHUNK) + 1))
        start = 0
        for i, end in enumerate(ends):
            lo = i * _BLOCK_CHUNK
            buf = self._pread(blocks[lo:lo + _BLOCK_CHUNK],
                              per * self._row_bytes).reshape(-1).view(row)
            rows[pos[start:end]] = buf[at[start:end] - lo * per]
            start = end
        return out

    def _pread(self, ids, row_bytes: int, out=None):
        """Records ``ids`` of ``row_bytes`` bytes each, into ``out`` (a
        contiguous uint8 array) or a new (len(ids), row_bytes) one."""
        if out is None:
            out = np.empty((ids.shape[0], row_bytes), np.uint8)
        got = _host.batched_pread(self._fd, self._offset0, ids, row_bytes,
                                  out.reshape(-1))
        if got != ids.shape[0]:
            raise DGLError(f"batched_pread read {got}/{ids.shape[0]} rows")
        return out

    def read_async(self, ids):
        """Submit the row fetch to a thread pool; returns a Future whose
        ``.result()`` is the (n, *feat) array. The native loop releases the
        GIL, so async reads overlap Python-side work."""
        if self._pool is None:
            from concurrent.futures import ThreadPoolExecutor

            self._pool = ThreadPoolExecutor(self._nworkers)
        return self._pool.submit(self.read, _asnumpy(ids))

    def size(self):
        return tuple(self._shape[1:])

    def count(self):
        return self._shape[0]

    def close(self):
        """Close the file and shut the thread pool down."""
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None
        if self._fd is not None:
            os.close(self._fd)
            self._fd = None

    def __del__(self):
        # interpreter teardown may have cleared module globals (os=None)
        if getattr(self, "_fd", None) is not None and os is not None:
            try:
                os.close(self._fd)
            except (OSError, TypeError):
                pass
        pool = getattr(self, "_pool", None)
        if pool is not None:
            pool.shutdown(wait=False)


class CachedFeature(Feature):
    """Cache wrapper (reference ``impl/cpu_cached_feature.py`` +
    ``partitioned_cache_policy.cc``)."""

    def __init__(self, fallback: Feature, capacity: int, policy: str = "sieve"):
        if policy not in cache_policies:
            raise DGLError(
                f"unknown policy {policy!r}; options {list(cache_policies)}"
            )
        self._fb = fallback
        self._policy: CachePolicy = cache_policies[policy](capacity)
        self._buf = np.zeros((capacity,) + tuple(fallback.size()),
                             dtype=_asnumpy(fallback.read(np.array([0]))).dtype)
        self.hits = 0
        self.misses = 0

    def read(self, ids=None):
        if ids is None:
            return self._fb.read()
        ids = _asnumpy(ids)
        out = np.empty((ids.shape[0],) + tuple(self._fb.size()),
                       self._buf.dtype)
        hit_pos, hit_slot = [], []
        miss_ids = []          # unique missing keys, in first-seen order
        miss_slots = []        # reserved slot per missing key
        pending = {}           # key -> index into miss_ids
        miss_pos = []          # (row in out, index into miss_ids)
        for i, key in enumerate(ids.tolist()):
            j = pending.get(key)
            if j is not None:  # dup of an in-flight miss: hit-after-fill
                self.hits += 1
                miss_pos.append((i, j))
                continue
            slot = self._policy.lookup(key)
            if slot is not None:
                hit_pos.append(i)
                hit_slot.append(slot)
                self.hits += 1
            else:
                self.misses += 1
                slot, _ = self._policy.insert(key)  # reserve slot now
                pending[key] = len(miss_ids)
                miss_pos.append((i, len(miss_ids)))
                miss_ids.append(key)
                miss_slots.append(slot)
        if hit_pos:
            out[np.asarray(hit_pos)] = self._buf[np.asarray(hit_slot)]
        if miss_ids:
            fetched = _asnumpy(self._fb.read(np.asarray(miss_ids)))
            self._buf[np.asarray(miss_slots)] = fetched
            for i, j in miss_pos:
                out[i] = fetched[j]
        return out

    def size(self):
        return self._fb.size()

    def count(self):
        return self._fb.count()

    @property
    def hit_rate(self):
        total = self.hits + self.misses
        return self.hits / total if total else 0.0


class FeatureStore:
    """Keyed collection of features (reference ``feature_store.py:139``):
    keys are (domain, type_name, feature_name)."""

    def __init__(self, features: Optional[Dict] = None):
        self._features: Dict[Tuple[str, str, str], Feature] = {}
        if features:
            for k, v in features.items():
                self._features[k] = v if isinstance(v, Feature) else NumpyFeature(v)

    def read(self, domain, type_name, feature_name, ids=None):
        return self._features[(domain, type_name, feature_name)].read(ids)

    def size(self, domain, type_name, feature_name):
        return self._features[(domain, type_name, feature_name)].size()

    def __setitem__(self, key, feature):
        self._features[key] = (
            feature if isinstance(feature, Feature) else NumpyFeature(feature)
        )

    def __getitem__(self, key) -> Feature:
        return self._features[key]

    def __contains__(self, key):
        return key in self._features

    def keys(self):
        return self._features.keys()
