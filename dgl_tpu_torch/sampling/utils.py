"""Sampling helpers (counterpart of ``dgl_tpu/sampling/utils.py``;
reference ``python/dgl/sampling/utils.py``)."""
from __future__ import annotations

from typing import Mapping

import numpy as np

from ..base import EID
from ..graph import Graph, _asnumpy

__all__ = ["EidExcluder"]


class EidExcluder:
    """Removes the edges whose parent edge ids lie in ``exclude_eids``
    from a sampled frontier (reference ``sampling/utils.py:26``).

    The frontier must carry its parent ids in ``edata[EID]``, as
    ``sample_neighbors`` stores them; the surviving edges keep theirs.
    ``exclude_eids`` is an id array, or a dict of edge type -> ids.
    """

    def __init__(self, exclude_eids):
        if isinstance(exclude_eids, Mapping):
            self._exclude = {k: _asnumpy(v).astype(np.int64)
                             for k, v in exclude_eids.items()}
        else:
            self._exclude = _asnumpy(exclude_eids).astype(np.int64)

    def _excl_for(self, g: Graph, cet):
        if isinstance(self._exclude, dict):
            for k, v in self._exclude.items():
                if g.to_canonical_etype(k) == cet:
                    return v
            return None
        return self._exclude

    def __call__(self, frontier: Graph) -> Graph:
        from ..transforms.functional import remove_edges

        for cet in frontier.canonical_etypes:
            excl = self._excl_for(frontier, cet)
            if excl is None or excl.size == 0:
                continue
            parent = frontier._edge_frames.get(cet, {}).get(EID)
            if parent is None:
                raise ValueError(
                    "frontier has no edata[EID]; sample with store_ids")
            located = np.nonzero(np.isin(_asnumpy(parent), excl))[0]
            if located.size:
                etype = cet if len(frontier.canonical_etypes) > 1 else None
                # store_ids=False: the gathered parent EID column survives
                frontier = remove_edges(frontier, located, etype)
        return frontier
