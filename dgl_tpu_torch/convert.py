"""Graph construction (counterpart of ``dgl_tpu/convert.py``)."""
from __future__ import annotations

from typing import Optional

import torch

from .graph import Graph, Relation, _asnumpy

__all__ = ["graph", "create_block"]


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


def create_block(data_dict, num_src_nodes: Optional[int] = None,
                 num_dst_nodes: Optional[int] = None, idtype=torch.int32,
                 num_edges: Optional[int] = None, device="cuda") -> Graph:
    """Create a message-flow-graph block (reference
    ``python/dgl/convert.py:389``; ``dgl_tpu/convert.py:97``).

    ``data_dict`` is a ``(src, dst)`` pair or a dict holding one canonical
    edge type and its pair; the counts are ints or, with the dict form,
    dicts keyed like the reference's. Without counts they are inferred
    from the ids. The index tensors are built on the host and placed on
    ``device``.
    """
    if isinstance(data_dict, dict):
        if len(data_dict) != 1:
            raise NotImplementedError(
                "blocks of several edge types: heterogeneous graphs "
                "(ROADMAP queue A1)")
        (cet, pair), = data_dict.items()
        st, _, dt = cet
        if isinstance(num_src_nodes, dict):
            num_src_nodes = num_src_nodes.get(st)
        if isinstance(num_dst_nodes, dict):
            num_dst_nodes = num_dst_nodes.get(dt)
        if isinstance(num_edges, dict):
            num_edges = num_edges.get(tuple(cet))
        if st != dt:
            raise NotImplementedError(
                "blocks between node types: heterogeneous graphs "
                "(ROADMAP queue A1)")
        cet, nt = tuple(cet), st
    else:
        pair, cet, nt = data_dict, ("_N", "_E", "_N"), "_N"
    src, dst = (_asnumpy(a) for a in pair)
    if num_src_nodes is None:
        num_src_nodes = int(src.max()) + 1 if src.size else 0
    if num_dst_nodes is None:
        num_dst_nodes = int(dst.max()) + 1 if dst.size else 0
    rel = Relation.from_coo(src, dst, int(num_src_nodes), int(num_dst_nodes),
                            idtype=idtype, num_edges=num_edges, device=device)
    return Graph({cet: rel}, {nt: int(num_src_nodes)},
                 {nt: int(num_dst_nodes)}, is_block=True)
