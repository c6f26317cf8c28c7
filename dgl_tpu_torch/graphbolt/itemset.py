"""ItemSet (counterpart of ``dgl_tpu/graphbolt/itemset.py``; reference
``python/dgl/graphbolt/itemset.py``): an indexable collection of items
(seed ids, (src, dst) pairs, (ids, labels) tuples) held as host numpy
arrays, which the item samplers shuffle with numpy generators."""
from __future__ import annotations

from typing import Dict, Tuple, Union

from ..graph import _asnumpy

__all__ = ["ItemSet", "ItemSetDict", "HeteroItemSet"]


class ItemSet:
    """Wraps one array or a tuple of aligned arrays with field names."""

    def __init__(self, items, names: Union[str, Tuple[str, ...], None] = None):
        if not isinstance(items, tuple):
            items = (items,)
        self._items = tuple(_asnumpy(x) for x in items)
        n = self._items[0].shape[0]
        for x in self._items:
            assert x.shape[0] == n, "aligned arrays required"
        if names is None:
            names = tuple(f"field{i}" for i in range(len(self._items)))
        if isinstance(names, str):
            names = (names,)
        assert len(names) == len(self._items)
        self._names = tuple(names)

    @property
    def names(self):
        return self._names

    def __len__(self):
        return self._items[0].shape[0]

    def __getitem__(self, idx):
        out = tuple(x[idx] for x in self._items)
        return out[0] if len(out) == 1 else out

    def __repr__(self):
        return f"ItemSet(len={len(self)}, names={self._names})"


class ItemSetDict:
    """Per-type item sets for heterogeneous seeds (reference
    ``itemset.py`` ``ItemSetDict``)."""

    def __init__(self, itemsets: Dict[str, ItemSet]):
        self._sets = dict(itemsets)

    def __len__(self):
        return sum(len(s) for s in self._sets.values())

    def keys(self):
        return self._sets.keys()

    def __getitem__(self, key: str) -> ItemSet:
        return self._sets[key]

    def items(self):
        return self._sets.items()


class HeteroItemSet(ItemSetDict):
    """Reference name for the per-type item set collection
    (``python/dgl/graphbolt/itemset.py`` HeteroItemSet, the successor of
    ItemSetDict). Iteration/indexing semantics are inherited."""
