"""ItemSampler (counterpart of ``dgl_tpu/graphbolt/item_sampler.py``;
reference ``python/dgl/graphbolt/item_sampler.py``): yields seed
MiniBatches from an ItemSet, shuffled by ``np.random.default_rng(seed)``
as the reference shuffles, so the same seed gives the same batches."""
from __future__ import annotations

from typing import Iterator, Optional

import numpy as np

from .itemset import ItemSet
from .minibatch import MiniBatch

__all__ = ["ItemSampler", "DistributedItemSampler", "minibatcher_default"]


class ItemSampler:
    def __init__(self, item_set: ItemSet, batch_size: int,
                 shuffle: bool = False, drop_last: bool = False,
                 seed: Optional[int] = None):
        self.item_set = item_set
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self._rng = np.random.default_rng(seed)

    def __iter__(self) -> Iterator[MiniBatch]:
        n = len(self.item_set)
        idx = np.arange(n)
        if self.shuffle:
            idx = self._rng.permutation(n)
        for lo in range(0, n, self.batch_size):
            sel = idx[lo : lo + self.batch_size]
            if self.drop_last and sel.shape[0] < self.batch_size:
                return
            items = self.item_set[sel]
            mb = MiniBatch()
            names = self.item_set.names
            if isinstance(items, tuple):
                for name, arr in zip(names, items):
                    if name in ("seeds", "seed_nodes"):
                        mb.seeds = arr
                    elif name in ("labels", "label"):
                        mb.labels = arr
                    else:
                        setattr(mb, "indexes", arr)
            else:
                mb.seeds = items
            yield mb

    def __len__(self):
        n = len(self.item_set)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size


def minibatcher_default(batch, names):
    """Map a batch of items to MiniBatch fields by name (reference
    ``item_sampler.py:19``)."""
    mb = MiniBatch()
    if names is None:
        from .base import gb_warning

        gb_warning(
            "Failed to map item list to `MiniBatch` as names are not "
            "provided; returning the item list as is."
        )
        return batch
    if len(names) == 1:
        setattr(mb, names[0], batch)
        return mb
    for name, item in zip(names, batch):
        if not hasattr(mb, name):
            raise AttributeError(f"MiniBatch has no attribute {name!r}")
        setattr(mb, name, item)
    return mb


class DistributedItemSampler(ItemSampler):
    """Rank-sharded ItemSampler (reference
    ``python/dgl/graphbolt/item_sampler.py`` DistributedItemSampler): each
    process iterates its own slice of the item set; with
    ``drop_uneven_inputs`` every rank sees the same number of batches (the
    collective-sync requirement)."""

    def __init__(self, item_set: ItemSet, batch_size: int,
                 shuffle: bool = False, drop_last: bool = False,
                 drop_uneven_inputs: bool = False,
                 rank: Optional[int] = None,
                 world_size: Optional[int] = None,
                 seed: Optional[int] = None):
        # ranks must agree on the permutation: pin the seed when shuffling
        if shuffle and seed is None:
            seed = 0
        super().__init__(item_set, batch_size, shuffle, drop_last, seed)
        self._seed_value = seed
        if rank is None or world_size is None:
            from ..distributed import get_rank, get_world_size

            rank = get_rank() if rank is None else rank
            world_size = (
                get_world_size() if world_size is None else world_size
            )
        self.rank = int(rank)
        self.world_size = int(world_size)
        self.drop_uneven_inputs = drop_uneven_inputs
        self._epoch = 0

    def _num_mine(self) -> int:
        n = len(self.item_set)
        if self.drop_uneven_inputs:
            return n // self.world_size
        # strided slice rank::world
        return (n - self.rank + self.world_size - 1) // self.world_size

    def _my_indices(self):
        n = len(self.item_set)
        # all ranks draw the same permutation (same (seed, epoch)
        # discipline as the reference's shared generator), then take a
        # strided slice. A FRESH generator per epoch keeps __len__ and
        # other calls from consuming shared rng state (ranks would
        # otherwise desynchronize if one calls len() first), while
        # successive epochs still reshuffle in lockstep.
        rng = np.random.default_rng(
            None if self._seed_value is None
            else (self._seed_value, self._epoch)
        )
        idx = rng.permutation(n) if self.shuffle else np.arange(n)
        mine = idx[self.rank::self.world_size]
        if self.drop_uneven_inputs:
            per = n // self.world_size
            mine = mine[:per]
        return mine

    def __iter__(self):
        mine = self._my_indices()
        self._epoch += 1
        for lo in range(0, mine.shape[0], self.batch_size):
            sel = mine[lo: lo + self.batch_size]
            if self.drop_last and sel.shape[0] < self.batch_size:
                return
            items = self.item_set[sel]
            mb = MiniBatch()
            if isinstance(items, tuple):
                for name, arr in zip(self.item_set.names, items):
                    if name in ("seeds", "seed_nodes"):
                        mb.seeds = arr
                    elif name in ("labels", "label"):
                        mb.labels = arr
                    else:
                        mb.indexes = arr
            else:
                mb.seeds = items
            yield mb

    def __len__(self):
        n = self._num_mine()
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size
