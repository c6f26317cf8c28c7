"""Worker-side helpers (counterpart of
``dgl_tpu/dataloading/worker_utils.py``; reference
``python/dgl/dataloading/dataloader.py:576-760``): strip the feature
columns a sampled graph shares with its parent before it crosses a
process boundary, and put them back after."""
from __future__ import annotations

import numpy as np

from ..graph import Graph

__all__ = ["remove_parent_storage_columns", "restore_parent_storage_columns",
           "CollateWrapper", "WorkerInitWrapper"]

_REMOVED = "__parent_storage__"


def _frame_pairs(item: Graph, g: Graph):
    yield item._node_frames, g._node_frames
    if item.is_block:
        yield item._dst_frames, g._node_frames
    yield item._edge_frames, g._edge_frames


def remove_parent_storage_columns(item, g: Graph):
    """Replace each column of ``item`` that is the parent's own tensor (the
    same object) with a marker (reference ``dataloader.py:576``)."""
    if not isinstance(item, Graph) or not isinstance(g, Graph):
        return item
    for frames, parent_frames in _frame_pairs(item, g):
        for t, subframe in frames.items():
            parent = parent_frames.get(t, {})
            for key in list(subframe.keys()):
                if subframe[key] is parent.get(key):
                    subframe[key] = (_REMOVED, key)
    return item


def restore_parent_storage_columns(item, g: Graph):
    """Put back the columns :func:`remove_parent_storage_columns` took
    (reference ``dataloader.py:600``)."""
    if not isinstance(item, Graph) or not isinstance(g, Graph):
        return item
    for frames, parent_frames in _frame_pairs(item, g):
        for t, subframe in frames.items():
            parent = parent_frames.get(t, {})
            for key, val in list(subframe.items()):
                if (isinstance(val, tuple) and len(val) == 2
                        and val[0] == _REMOVED):
                    subframe[key] = parent[val[1]]
    return item


class CollateWrapper:
    """Run a sample function on the graph and strip the parent's columns
    from the graphs it returns (reference ``dataloader.py:722``);
    ``use_uva`` and ``device`` are kept for the reference's signature."""

    def __init__(self, sample_func, g, use_uva: bool = False, device=None):
        self.sample_func = sample_func
        self.g = g
        self.use_uva = use_uva
        self.device = device

    def __call__(self, items):
        batch = self.sample_func(self.g, items)

        def strip(x):
            return remove_parent_storage_columns(x, self.g)

        if isinstance(batch, tuple):
            return tuple(strip(b) if isinstance(b, Graph)
                         else [strip(bb) for bb in b] if isinstance(b, list)
                         else b for b in batch)
        return strip(batch)


class WorkerInitWrapper:
    """A worker's init hook (reference ``dataloader.py:746``): seeds
    numpy's global generator from the worker id, then calls ``func``."""

    def __init__(self, func=None):
        self.func = func

    def __call__(self, worker_id: int):
        np.random.seed((np.random.SeedSequence(worker_id).entropy or 0)
                       % (2**32 - 1) + worker_id)
        if self.func is not None:
            self.func(worker_id)
