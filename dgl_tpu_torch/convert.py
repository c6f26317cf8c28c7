"""Graph construction (counterpart of ``dgl_tpu/convert.py``)."""
from __future__ import annotations

from typing import Optional

import torch

from .graph import Graph, Relation, _asnumpy

__all__ = ["graph"]


def _infer_num_nodes(src, dst) -> int:
    src = _asnumpy(src)
    dst = _asnumpy(dst)
    if src.size == 0:
        return 0
    return int(max(src.max(), dst.max())) + 1


def graph(data, *, num_nodes: Optional[int] = None, idtype=torch.int32,
          num_edges: Optional[int] = None, device="cuda") -> Graph:
    """Create a homogeneous graph from an edge tuple ``(src, dst)``.

    Mirrors ``dgl.graph`` (reference ``python/dgl/convert.py:32``).
    ``num_edges`` < len(src) marks trailing edges as padding. The index
    tensors are built on the host and placed on ``device``.
    """
    src, dst = data
    n = num_nodes if num_nodes is not None else _infer_num_nodes(src, dst)
    rel = Relation.from_coo(src, dst, n, n, idtype=idtype,
                            num_edges=num_edges, device=device)
    return Graph({("_N", "_E", "_N"): rel}, {"_N": n})
