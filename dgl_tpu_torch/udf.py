"""User-defined-function batch views (counterpart of ``dgl_tpu/udf.py``;
reference ``python/dgl/udf.py:5,241``).

``EdgeBatch`` exposes ``.src`` / ``.dst`` / ``.data`` dicts of per-edge
(eid-order) tensors; ``NodeBatch`` exposes ``.data`` and ``.mailbox``.

As in ``dgl_tpu``, a reduce UDF gets one padded mailbox of shape
(N, max_in_degree, feat) for all destinations at once instead of the
reference's degree buckets, zero-padded, with ``NodeBatch.mailbox_mask``
marking the real slots. Sum-style UDFs work unchanged; mean and max UDFs
should use the mask.
"""
from __future__ import annotations

from typing import Dict, Optional


class EdgeBatch:
    """Batch of edges for an edge UDF (reference ``udf.py:5``)."""

    def __init__(self, src_data: Dict, edge_data: Dict, dst_data: Dict,
                 edges=None):
        self._src = src_data
        self._edata = edge_data
        self._dst = dst_data
        self._edges = edges

    @property
    def src(self) -> Dict:
        return self._src

    @property
    def dst(self) -> Dict:
        return self._dst

    @property
    def data(self) -> Dict:
        return self._edata

    def edges(self):
        return self._edges

    def batch_size(self):
        for v in self._edata.values():
            return v.shape[0]
        for v in self._src.values():
            return v.shape[0]
        return 0


class NodeBatch:
    """Batch of nodes for a node UDF (reference ``udf.py:241``)."""

    def __init__(self, data: Dict, msgs: Optional[Dict] = None,
                 msgs_mask=None, nodes=None):
        self._data = data
        self._msgs = msgs
        self._msgs_mask = msgs_mask
        self._nodes = nodes

    @property
    def data(self) -> Dict:
        return self._data

    @property
    def mailbox(self) -> Optional[Dict]:
        return self._msgs

    @property
    def mailbox_mask(self):
        """(N, max_in_degree) bool mask of the real mailbox slots."""
        return self._msgs_mask

    def nodes(self):
        return self._nodes

    def batch_size(self):
        for v in self._data.values():
            return v.shape[0]
        return 0
