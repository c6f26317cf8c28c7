"""Tensorised datasets and collators (counterpart of
``dgl_tpu/dataloading/collators.py``; reference
``python/dgl/dataloading/dataloader.py:191,255,757,1279`` and
``python/dgl/distributed/dist_dataloader.py:337,434``).

Host-side iterables for users who compose their own loops; the
prefetching ``DataLoader`` covers pipelined iteration.
"""
from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from ..graph import _asnumpy

__all__ = ["TensorizedDataset", "DDPTensorizedDataset",
           "create_tensorized_dataset", "NodeCollator", "EdgeCollator",
           "GraphCollator", "Collator"]


class TensorizedDataset:
    """Batches of an id array (reference ``dataloader.py:191``): iterating
    yields host arrays of ``batch_size`` ids (the last may be short unless
    ``drop_last``); a dict of ids by type yields lists of ``(type, id)``
    pairs."""

    def __init__(self, indices, batch_size: int, drop_last: bool = False,
                 shuffle: bool = False, seed: Optional[int] = None):
        if isinstance(indices, Mapping):
            self._items = [(nt, int(i)) for nt, ids in indices.items()
                           for i in _asnumpy(ids)]
            self._array = None
        else:
            self._array = _asnumpy(indices)
            self._items = None
        self.batch_size = int(batch_size)
        self.drop_last = drop_last
        self.shuffle = shuffle
        self._rng = np.random.default_rng(seed)

    def _count(self) -> int:
        return len(self._array) if self._array is not None else len(
            self._items)

    def _ordered(self):
        order = np.arange(self._count())
        if self.shuffle:
            self._rng.shuffle(order)
        return order

    def __iter__(self):
        order = self._ordered()
        n = order.shape[0]
        stop = (n // self.batch_size) * self.batch_size if self.drop_last \
            else n
        for lo in range(0, stop, self.batch_size):
            sel = order[lo:lo + self.batch_size]
            if self._array is not None:
                yield self._array[sel]
            else:
                yield [self._items[i] for i in sel]

    def __len__(self):
        n = self._count()
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size


def _rank_and_world():
    """This process's rank and the world size of the default
    ``torch.distributed`` group, or 0 and 1 without one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class DDPTensorizedDataset(TensorizedDataset):
    """Rank-sharded batches (reference ``dataloader.py:255``): each
    process iterates its own contiguous shard; without ``drop_last`` the
    shards are padded by wrap-around so every rank sees as many batches.
    ``rank`` and ``world_size`` default to the ``torch.distributed``
    group's."""

    def __init__(self, indices, batch_size: int, drop_last: bool = False,
                 shuffle: bool = False, seed: Optional[int] = None,
                 rank: Optional[int] = None,
                 world_size: Optional[int] = None):
        super().__init__(indices, batch_size, drop_last, shuffle, seed)
        if rank is None or world_size is None:
            r, w = _rank_and_world()
            rank = r if rank is None else rank
            world_size = w if world_size is None else world_size
        self.rank = int(rank)
        self.world_size = int(world_size)

    def _ordered(self):
        order = super()._ordered()
        n = order.shape[0]
        per = n // self.world_size
        if self.drop_last or n % self.world_size == 0:
            return order[self.rank * per:(self.rank + 1) * per]
        per = -(-n // self.world_size)
        padded = np.concatenate([order, order[:per * self.world_size - n]])
        return padded[self.rank * per:(self.rank + 1) * per]

    def __len__(self):
        n = self._count()
        per = (n // self.world_size) if self.drop_last else -(
            -n // self.world_size)
        if self.drop_last:
            return per // self.batch_size
        return (per + self.batch_size - 1) // self.batch_size


def create_tensorized_dataset(indices, batch_size, drop_last=False,
                              use_ddp=False, ddp_seed=0, shuffle=False,
                              **kwargs):
    """(reference ``dataloader.py:757``)."""
    if use_ddp:
        return DDPTensorizedDataset(indices, batch_size, drop_last, shuffle,
                                    seed=ddp_seed, **kwargs)
    return TensorizedDataset(indices, batch_size, drop_last, shuffle,
                             **kwargs)


class NodeCollator:
    """``(input_nodes, output_nodes, blocks)`` for node prediction
    (reference ``dist_dataloader.py:337``)."""

    def __init__(self, g, nids, graph_sampler):
        self.g = g
        self.nids = nids
        self.graph_sampler = graph_sampler

    @property
    def dataset(self):
        return self.nids if isinstance(self.nids, Mapping) else _asnumpy(
            self.nids)

    def collate(self, items):
        if items and isinstance(items[0], tuple):
            grouped = {}
            for nt, i in items:
                grouped.setdefault(nt, []).append(i)
            items = {nt: np.asarray(v) for nt, v in grouped.items()}
        else:
            items = _asnumpy(items) if isinstance(items, torch.Tensor) \
                else np.asarray(items)
        return self.graph_sampler.sample_blocks(self.g, items)


class EdgeCollator:
    """``(input_nodes, pair_graph[, neg_pair_graph], blocks)`` for edge
    prediction (reference ``dist_dataloader.py:434``)."""

    def __init__(self, g, eids, graph_sampler, exclude=None,
                 reverse_eids=None, reverse_etypes=None,
                 negative_sampler=None):
        from .base import EdgePredictionSampler

        self.g = g
        self.eids = eids
        self._sampler = EdgePredictionSampler(
            graph_sampler, exclude, reverse_eids, reverse_etypes,
            negative_sampler)

    @property
    def dataset(self):
        return _asnumpy(self.eids)

    def collate(self, items):
        return self._sampler.sample(self.g, np.asarray(_asnumpy(items)))


class GraphCollator:
    """Batch whole graphs, descending into ``(graph, label)`` tuples
    (reference ``dataloader.py:1279``); other items become a tensor on
    ``device``."""

    def __init__(self, device="cuda"):
        self.device = torch.device(device)

    def collate(self, items):
        from ..batch import batch as batch_graphs
        from ..graph import Graph

        elem = items[0]
        if isinstance(elem, Graph):
            return batch_graphs(items)
        if isinstance(elem, (tuple, list)):
            return tuple(self.collate([it[i] for it in items])
                         for i in range(len(elem)))
        return torch.as_tensor(np.asarray([_asnumpy(x) for x in items]),
                               device=self.device)


class Collator:
    """Abstract collator (reference ``dist_dataloader.py:276``):
    ``dataset`` and ``collate``."""

    @property
    def dataset(self):
        raise NotImplementedError

    def collate(self, items):
        raise NotImplementedError

    @staticmethod
    def add_edge_attribute_to_graph(g, prob, padding=1):
        """The reference's hook for GraphBolt partitions; a graph here
        carries its edge features already, so it returns ``g``."""
        return g
