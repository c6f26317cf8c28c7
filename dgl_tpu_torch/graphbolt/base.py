"""GraphBolt functional surface (counterpart of ``dgl_tpu/graphbolt/base.py``;
reference ``python/dgl/graphbolt/base.py`` and ``internal/sample_utils.py``):
constants, edge-type string codecs, and the index and compaction primitives
the sampling pipeline is built from.

Host numpy throughout: the pipeline's index work is host work that feeds
the device's minibatches. Unique-and-relabel is ``csrc/host_ops.cpp``'s
hash map through ``_host.py``, built at first use; a failed build raises.
"""
from __future__ import annotations

import warnings
from typing import Dict, List, Union

import numpy as np
import torch

from .. import _host
from .impl.fused_csc_sampling_graph import CSCFormatBase

CANONICAL_ETYPE_DELIMITER = ":"
ORIGINAL_EDGE_ID = "_ORIGINAL_EDGE_ID"

__all__ = [
    "CANONICAL_ETYPE_DELIMITER",
    "ORIGINAL_EDGE_ID",
    "isin",
    "index_select",
    "expand_indptr",
    "indptr_edge_ids",
    "etype_tuple_to_str",
    "etype_str_to_tuple",
    "seed_type_str_to_ntypes",
    "unique_and_compact",
    "unique_and_compact_csc_formats",
    "compact_csc_format",
    "compact_temporal_nodes",
    "gb_warning",
    "gb_warning_format",
    "is_listlike",
    "is_scalar",
    "get_attributes",
    "get_nonproperty_attributes",
    "apply_to",
    "recursive_apply",
    "recursive_apply_reduce_all",
    "bytes_to_number_of_items",
    "built_with_cuda",
    "is_wsl",
    "is_object_pinned",
]


# -- warnings (reference ``base.py`` gb_warning) ------------------------------


class GBWarning(UserWarning):
    pass


def gb_warning_format(message, category, filename, lineno, line=None):
    """Short single-line warning format (reference ``base.py``)."""
    return f"GraphBolt warning: {message}\n"


def gb_warning(message, category=GBWarning, stacklevel=2):
    warnings.warn(message, category, stacklevel=stacklevel)


# -- tensor primitives --------------------------------------------------------


def isin(elements, test_elements):
    """Membership test (reference ``base.py:79`` -> C++ isin)."""
    elements = np.asarray(elements)
    assert elements.ndim == 1, "Elements should be 1D tensor."
    return np.isin(elements, np.asarray(test_elements))


def index_select(tensor, index):
    """Row gather (reference ``base.py:215``)."""
    index = np.asarray(index)
    assert index.ndim == 1, "Index should be 1D tensor."
    return np.asarray(tensor)[index]


def expand_indptr(indptr, dtype=None, node_ids=None, output_size=None):
    """indptr -> per-edge column ids, i.e. CSC->COO (reference
    ``base.py:119`` -> C++ ExpandIndptr)."""
    indptr = np.asarray(indptr)
    assert indptr.ndim == 1, "Indptr should be 1D tensor."
    assert not (node_ids is None and dtype is None), \
        "One of node_ids or dtype must be given."
    if node_ids is None:
        node_ids = np.arange(indptr.shape[0] - 1, dtype=dtype)
    node_ids = np.asarray(node_ids)
    out = np.repeat(node_ids, np.diff(indptr))
    if dtype is not None:
        out = out.astype(dtype)
    if output_size is not None:
        assert out.shape[0] == output_size
    return out


def indptr_edge_ids(indptr, dtype=None, offset=None, output_size=None):
    """Per-position edge ids within each indptr bucket, shifted by
    ``offset`` (reference ``base.py:182``): for indptr [0,2,5,7] and offset
    [0,100,200] -> [0,1,100,101,102,201,202]."""
    indptr = np.asarray(indptr)
    assert indptr.ndim == 1, "Indptr should be 1D tensor."
    deg = np.diff(indptr)
    total = int(indptr[-1] - indptr[0])
    # within-bucket ranks: arange minus each bucket's start
    starts = np.repeat(indptr[:-1] - indptr[0], deg)
    out = np.arange(total, dtype=np.int64) - starts
    if offset is not None:
        out = out + np.repeat(np.asarray(offset), deg)
    if dtype is not None:
        out = out.astype(dtype)
    if output_size is not None:
        assert out.shape[0] == output_size
    return out


# -- etype codecs (reference ``base.py:243-320``) ------------------------------


def etype_tuple_to_str(c_etype):
    assert isinstance(c_etype, tuple) and len(c_etype) == 3, (
        "Passed-in canonical etype should be in format of (str, str, str). "
        f"But got {c_etype}."
    )
    return CANONICAL_ETYPE_DELIMITER.join(c_etype)


def etype_str_to_tuple(c_etype):
    if isinstance(c_etype, tuple):
        return c_etype
    ret = tuple(c_etype.split(CANONICAL_ETYPE_DELIMITER))
    assert len(ret) == 3, (
        "Passed-in canonical etype should be in format of 'str:str:str'. "
        f"But got {c_etype}."
    )
    return ret


def seed_type_str_to_ntypes(seed_type, seed_size):
    """'user:like:item' with seed_size 2 -> ['user', 'item']; hyperlink
    types list all ntypes (reference ``base.py:280``)."""
    parts = seed_type.split(CANONICAL_ETYPE_DELIMITER)
    if len(parts) == 3 and seed_size == 2:
        return [parts[0], parts[2]]
    assert len(parts) == seed_size, (
        f"seed_type {seed_type!r} incompatible with seed_size {seed_size}"
    )
    return parts


# -- compaction (reference ``internal/sample_utils.py``) ----------------------


def _unique_first_occurrence_inverse(cat: np.ndarray):
    """(unique ids in first-occurrence order, per-element new ids) from the
    host library's hash map (``csrc/host_ops.cpp::unique_and_compact``):
    the order and labels of ``graph.unique_first_occurrence``."""
    return _host.unique_and_compact(np.ascontiguousarray(cat, np.int64))


def unique_and_compact(
    nodes: Union[List, Dict[str, List]],
    rank: int = 0,
    world_size: int = 1,
    async_op: bool = False,
):
    """Unique + relabel a list of node-id arrays (reference
    ``internal/sample_utils.py:11``; C++
    ``graphbolt/src/unique_and_compact.cc``).

    Returns ``(unique, compacted_list, offsets)``; for ``world_size > 1``
    the unique ids are grouped by owner rank (owner = id % world_size) in
    the rotated order ``[rank, rank+1, ..., 0, ..., rank-1]`` and
    ``offsets`` (world_size+1) partitions them — the cooperative
    minibatching layout. ``async_op`` returns a ``.wait()`` wrapper (the
    host pipeline is synchronous; the API matches the reference).
    """
    is_hetero = isinstance(nodes, dict)
    if not is_hetero:
        nodes = {"_N": nodes}
    unique, compacted, offsets = {}, {}, {}
    for ntype, arrs in nodes.items():
        arrs = [np.asarray(a) for a in arrs]
        nums = [a.shape[0] for a in arrs]
        cat = np.concatenate(arrs) if arrs else np.zeros(0, np.int64)
        uniq, relabeled = _unique_first_occurrence_inverse(cat)
        if world_size > 1:
            owner = uniq % world_size
            order_of_owner = (owner - rank) % world_size
            perm = np.argsort(order_of_owner, kind="stable")
            uniq = uniq[perm]
            # remap the inverse through the permutation
            rank_of = np.empty_like(perm)
            rank_of[perm] = np.arange(perm.shape[0])
            relabeled = rank_of[relabeled] if relabeled.size else relabeled
            counts = np.bincount(order_of_owner, minlength=world_size)
            offsets[ntype] = np.concatenate([[0], np.cumsum(counts)])
        else:
            offsets[ntype] = np.array([0, uniq.shape[0]], dtype=np.int64)
        splits = np.cumsum(nums)[:-1]
        compacted[ntype] = list(np.split(relabeled, splits))
        unique[ntype] = uniq
    if not is_hetero:
        unique, compacted, offsets = (
            unique["_N"], compacted["_N"], offsets["_N"]
        )

    class _Waiter:
        def __init__(self, value):
            self._value = value

        def wait(self):
            return self._value

    result = (unique, compacted, offsets)
    return _Waiter(result) if async_op else result


def compact_temporal_nodes(nodes, nodes_timestamp):
    """Concatenate-without-unique compaction (reference
    ``internal/sample_utils.py:126``)."""

    def _per_type(arrs, stamps):
        arrs = [np.asarray(a) for a in arrs]
        stamps = [np.asarray(t) for t in stamps]
        nums = [a.shape[0] for a in arrs]
        cat = np.concatenate(arrs) if arrs else np.zeros(0, np.int64)
        cat_t = np.concatenate(stamps) if stamps else np.zeros(0, np.int64)
        comp = np.arange(cat.shape[0], dtype=cat.dtype)
        splits = np.cumsum(nums)[:-1]
        return cat, cat_t, list(np.split(comp, splits))

    if isinstance(nodes, dict):
        rn, rt, rc = {}, {}, {}
        for ntype, arrs in nodes.items():
            rn[ntype], rt[ntype], rc[ntype] = _per_type(
                arrs, nodes_timestamp[ntype]
            )
        return rn, rt, rc
    return _per_type(nodes, nodes_timestamp)


def _split_etype(etype):
    src, _, dst = etype_str_to_tuple(etype)
    return src, dst


def compact_csc_format(
    csc_formats: Union[CSCFormatBase, Dict[str, CSCFormatBase]],
    dst_nodes,
    dst_timestamps=None,
):
    """Relabel row ids to a contiguous range with dst nodes FIRST and
    repeated rows kept distinct (reference
    ``internal/sample_utils.py:371``). Returns
    ``(original_row_node_ids, compacted_csc_formats[, src_timestamps])``.
    """
    is_hetero = isinstance(csc_formats, dict)
    if not is_hetero:
        csc_formats = {"_N:_E:_N": csc_formats}
        dst_nodes = {"_N": np.asarray(dst_nodes)}
        if dst_timestamps is not None:
            dst_timestamps = {"_N": np.asarray(dst_timestamps)}
    original_row_ids = {
        nt: [np.asarray(v)] for nt, v in dst_nodes.items()
    }
    src_timestamps = (
        {nt: [np.asarray(v)] for nt, v in dst_timestamps.items()}
        if dst_timestamps is not None else None
    )
    compacted = {}
    for etype, csc in csc_formats.items():
        src_t, dst_t = _split_etype(etype)
        offset = sum(a.shape[0] for a in original_row_ids.setdefault(
            src_t, []
        ))
        indices = np.asarray(csc.indices)
        original_row_ids[src_t].append(indices)
        compacted[etype] = CSCFormatBase(
            indptr=np.asarray(csc.indptr),
            indices=np.arange(
                offset, offset + indices.shape[0], dtype=np.int64
            ),
        )
        if src_timestamps is not None:
            # broadcast each dst's timestamp to its in-edges; a src type
            # that is never a seed type starts with no entries
            deg = np.diff(np.asarray(csc.indptr))
            src_timestamps.setdefault(src_t, []).append(
                np.repeat(np.asarray(dst_timestamps[dst_t]), deg)
            )
    original_row_ids = {
        nt: np.concatenate(parts) for nt, parts in original_row_ids.items()
    }
    if src_timestamps is not None:
        src_timestamps = {
            nt: np.concatenate(parts) for nt, parts in src_timestamps.items()
        }
    if not is_hetero:
        original_row_ids = original_row_ids["_N"]
        compacted = compacted["_N:_E:_N"]
        if src_timestamps is not None:
            src_timestamps = src_timestamps["_N"]
    if dst_timestamps is not None:
        return original_row_ids, compacted, src_timestamps
    return original_row_ids, compacted


def unique_and_compact_csc_formats(
    csc_formats: Union[CSCFormatBase, Dict[str, CSCFormatBase]],
    unique_dst_nodes,
    rank: int = 0,
    world_size: int = 1,
    async_op: bool = False,
):
    """Like :func:`compact_csc_format` but with UNIQUE row ids; dst nodes
    take the first slots (reference ``internal/sample_utils.py:181``).
    Returns ``(unique_nodes, compacted_csc_formats, offsets)``."""
    is_hetero = isinstance(csc_formats, dict)
    if not is_hetero:
        csc_formats = {"_N:_E:_N": csc_formats}
        unique_dst_nodes = {"_N": np.asarray(unique_dst_nodes)}
    per_type_lists: Dict[str, List[np.ndarray]] = {
        nt: [np.asarray(v)] for nt, v in unique_dst_nodes.items()
    }
    slot_of_etype = {}
    for etype, csc in csc_formats.items():
        src_t, _ = _split_etype(etype)
        per_type_lists.setdefault(src_t, [np.asarray([], np.int64)])
        slot_of_etype[etype] = (src_t, len(per_type_lists[src_t]))
        per_type_lists[src_t].append(np.asarray(csc.indices))
    unique, compacted_lists, offsets = unique_and_compact(
        per_type_lists, rank, world_size
    )
    compacted = {}
    for etype, csc in csc_formats.items():
        src_t, slot = slot_of_etype[etype]
        compacted[etype] = CSCFormatBase(
            indptr=np.asarray(csc.indptr),
            indices=compacted_lists[src_t][slot],
        )
    if not is_hetero:
        unique = unique["_N"]
        compacted = compacted["_N:_E:_N"]
        offsets = offsets["_N"]

    class _Waiter:
        def __init__(self, value):
            self._value = value

        def wait(self):
            return self._value

    result = (unique, compacted, offsets)
    return _Waiter(result) if async_op else result


# -- reflection / pytree helpers (reference ``base.py`` + minibatch utils) ----


def is_listlike(x) -> bool:
    return isinstance(x, (list, tuple))


def is_scalar(x) -> bool:
    if isinstance(x, (int, float, bool, complex)):
        return True
    return hasattr(x, "ndim") and getattr(x, "ndim") == 0


def get_attributes(obj) -> list:
    """All public data attribute names of an object (reference
    ``internal/utils.py`` get_attributes)."""
    attrs = [
        a for a in dir(obj)
        if not a.startswith("_") and not callable(getattr(obj, a))
    ]
    return attrs


def get_nonproperty_attributes(obj) -> list:
    """Attribute names excluding class properties (reference
    ``internal/utils.py``)."""
    return [
        a for a in get_attributes(obj)
        if not isinstance(getattr(type(obj), a, None), property)
    ]


def recursive_apply(data, fn, *args):
    """Apply fn over nested lists/tuples/dicts (reference
    ``python/dgl/utils/internal.py`` recursive_apply)."""
    if isinstance(data, dict):
        return {k: recursive_apply(v, fn, *args) for k, v in data.items()}
    if isinstance(data, (list, tuple)):
        out = [recursive_apply(v, fn, *args) for v in data]
        return type(data)(out) if isinstance(data, tuple) else out
    return fn(data, *args)


def recursive_apply_reduce_all(data, fn, *args) -> bool:
    """True iff fn holds for every leaf (reference
    ``utils/internal.py``)."""
    if isinstance(data, dict):
        return all(
            recursive_apply_reduce_all(v, fn, *args) for v in data.values()
        )
    if isinstance(data, (list, tuple)):
        return all(recursive_apply_reduce_all(v, fn, *args) for v in data)
    return bool(fn(data, *args))


def apply_to(x, device, non_blocking: bool = False):
    """Move array leaves to ``device`` as tensors (reference ``base.py``
    apply_to); strings and numbers pass through."""
    device = torch.device(device)

    def move(v):
        if v is None or isinstance(v, (str, int, float, bool)):
            return v
        if isinstance(v, np.ndarray):
            v = torch.from_numpy(np.ascontiguousarray(v))
        if isinstance(v, torch.Tensor):
            return v.to(device, non_blocking=non_blocking)
        return v.to(device)

    return recursive_apply(x, move)


def bytes_to_number_of_items(cache_capacity_in_bytes, sample_item) -> int:
    """How many rows fit in a byte budget (reference ``base.py``)."""
    sample_item = np.asarray(sample_item)
    row_bytes = sample_item.nbytes // max(sample_item.shape[0], 1) \
        if sample_item.ndim > 0 else sample_item.nbytes
    return int(cache_capacity_in_bytes // max(row_bytes, 1))


def built_with_cuda() -> bool:
    """Whether this PyTorch was built with CUDA (reference ``base.py``
    built_with_cuda asks the same of its C++ library)."""
    return torch.version.cuda is not None


def is_wsl() -> bool:
    """WSL detection (reference ``internal_utils.py``)."""
    import platform

    return "microsoft" in platform.uname().release.lower()


def is_object_pinned(obj) -> bool:
    """Whether ``obj`` is a tensor in pinned host memory (reference
    ``base.py`` is_object_pinned)."""
    return isinstance(obj, torch.Tensor) and obj.is_pinned()
