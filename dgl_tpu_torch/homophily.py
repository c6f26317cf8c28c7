"""Homophily measures (counterpart of ``dgl_tpu/homophily.py``; reference
``python/dgl/homophily.py``) and label informativeness (reference
``python/dgl/label_informativeness.py``).

Each measure runs on the graph's device in float64: counts a node or a
class pair by ``index_add_``, then one host read of the result. The
counts are whole numbers, exact in float64, so a measure differs from the
JAX package's numpy one only by the order of its final sums.
"""
from __future__ import annotations

import torch

from .graph import Graph

__all__ = [
    "node_homophily",
    "edge_homophily",
    "linkx_homophily",
    "adjusted_homophily",
    "edge_label_informativeness",
    "node_label_informativeness",
    "get_long_edges",
]


def _edges(g: Graph):
    rel = g._relation(None)
    E = rel.num_edges
    return rel.src[:E].long(), rel.dst[:E].long()


def _labels(y, device) -> torch.Tensor:
    return torch.as_tensor(y).to(device=device, dtype=torch.int64)


def _per_dst(values, dst, n):
    """(n,) float64 sums of ``values`` by destination."""
    return torch.zeros(n, dtype=torch.float64, device=dst.device).index_add_(
        0, dst, values)


def node_homophily(graph: Graph, y) -> float:
    """Mean over nodes of the same-label fraction of in-neighbors
    (reference ``homophily.py:34``)."""
    src, dst = _edges(graph)
    y = _labels(y, src.device)
    n = graph.num_nodes()
    same = (y[src] == y[dst]).double()
    num = _per_dst(same, dst, n)
    den = _per_dst(torch.ones_like(same), dst, n)
    has = den > 0
    return float((num[has] / den[has]).sum() / n)


def edge_homophily(graph: Graph, y) -> float:
    """Fraction of edges connecting same-label nodes (reference
    ``homophily.py:86``)."""
    src, dst = _edges(graph)
    y = _labels(y, src.device)
    if src.numel() == 0:
        return 0.0
    return float((y[src] == y[dst]).double().mean())


def linkx_homophily(graph: Graph, y) -> float:
    """LINKX class-adjusted homophily (reference ``homophily.py:131``):
    mean over classes of max(0, h_k - |C_k|/n), ``h_k`` the mean over the
    class's nodes with in-edges of their same-label fraction."""
    src, dst = _edges(graph)
    y = _labels(y, src.device)
    n = graph.num_nodes()
    C = int(y.max()) + 1
    same = (y[src] == y[dst]).double()
    deg = _per_dst(torch.ones_like(same), dst, n)
    hit = _per_dst(same, dst, n)
    has = deg > 0
    yk = y[has]
    count = torch.bincount(yk, minlength=C).double()
    ratio_sum = torch.zeros(C, dtype=torch.float64, device=y.device
                            ).index_add_(0, yk, hit[has] / deg[has])
    present = count > 0
    hk = ratio_sum[present] / count[present]
    return float((hk - count[present] / n).clamp_min(0.0).sum() / C)


def adjusted_homophily(graph: Graph, y) -> float:
    """Degree-corrected homophily (reference ``homophily.py:197``)."""
    src, dst = _edges(graph)
    y = _labels(y, src.device)
    E = src.numel()
    if E == 0:
        return 0.0
    h_edge = float((y[src] == y[dst]).double().mean())
    C = int(y.max()) + 1
    ones = torch.ones(E, dtype=torch.float64, device=src.device)
    deg = _per_dst(ones, dst, graph.num_nodes()).index_add_(0, src, ones)
    dk = torch.zeros(C, dtype=torch.float64, device=y.device).index_add_(
        0, y, deg)
    p2 = float(((dk / (2 * E)) ** 2).sum())
    if p2 >= 1.0:
        return 0.0
    return (h_edge - p2) / (1 - p2)


def _mutual_information(graph: Graph, y, per_node: bool):
    """Shared core of edge/node label informativeness (reference
    ``label_informativeness.py``): LI = I(y_u, y_v) / H(y)."""
    src, dst = _edges(graph)
    y = _labels(y, src.device)
    C = int(y.max()) + 1
    if per_node:
        # weight each edge by 1/deg(dst): every node contributes equally
        deg = _per_dst(torch.ones(src.numel(), dtype=torch.float64,
                                  device=src.device), dst, graph.num_nodes())
        w = 1.0 / deg[dst].clamp_min(1.0)
    else:
        w = torch.ones(src.numel(), dtype=torch.float64, device=src.device)
    w = w / w.sum()
    joint = torch.zeros(C * C, dtype=torch.float64, device=y.device
                        ).index_add_(0, y[src] * C + y[dst], w).reshape(C, C)
    pu = joint.sum(1)
    pv = joint.sum(0)
    nz = joint > 0
    mi = (joint[nz] * torch.log(joint[nz] / torch.outer(pu, pv)[nz])).sum()
    pos = pv[pv > 0]
    hy = -(pos * torch.log(pos)).sum()
    if float(hy) == 0:
        return 0.0
    return float(mi / hy)


def edge_label_informativeness(graph: Graph, y) -> float:
    return _mutual_information(graph, y, per_node=False)


def node_label_informativeness(graph: Graph, y) -> float:
    return _mutual_information(graph, y, per_node=True)


def get_long_edges(graph):
    """(src, dst) of the real edges as int64 tensors on the graph's device
    (reference ``homophily.py:28``)."""
    src, dst = graph.edges()
    return src.long(), dst.long()
