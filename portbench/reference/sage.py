"""GraphSAGE (mean aggregator) as DGL's ``SAGEConv`` defines it, over one
homogeneous edge list: per layer ``fc_self(h) + fc_neigh(mean over
in-edges of h) + bias``, ReLU and dropout between layers. Where a layer
narrows (``in > out``) the neighbour projection runs before the mean, as
DGL's ``lin_before_mp``; the mean divides the sum by the in-degree clamped
at 1. Parameter names are the program's ``state_dict`` names.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..inputs import HOMOGENEOUS
from .common import (BIAS_BOUND, Precision, degrees, matmul, rounded_sum,
                     xavier_bound)

RELATION = HOMOGENEOUS[1]


def _dims(cfg: dict) -> list:
    hidden = [cfg["hidden_channels"]] * (cfg["num_layers"] - 1)
    return [cfg["in_channels"]] + hidden + [cfg["out_channels"]]


def param_shapes(cfg: dict) -> dict:
    dims, out = _dims(cfg), {}
    for i, (fi, fo) in enumerate(zip(dims, dims[1:])):
        out[f"sage{i}.fc_neigh.weight"] = ((fo, fi), xavier_bound(fi, fo))
        out[f"sage{i}.fc_self.weight"] = ((fo, fi), xavier_bound(fi, fo))
        out[f"sage{i}.bias"] = ((fo,), BIAS_BOUND)
    return out


def forward(cfg: dict, params: dict, inputs, prec: Precision, masks=None):
    """The logits of every node; ``masks`` (one a hidden layer, already
    scaled by 1 / (1 - p)) apply dropout, None leaves it out (eval)."""
    src, dst = inputs.relations[HOMOGENEOUS]
    n = inputs.num_nodes["_N"]
    deg = degrees(dst, n).clamp_(min=1).unsqueeze(1)
    h = inputs.feats["_N"]
    layers = cfg["num_layers"]
    for i in range(layers):
        wn = params[f"sage{i}.fc_neigh.weight"]
        ws = params[f"sage{i}.fc_self.weight"]
        if wn.shape[1] > wn.shape[0]:
            neigh = rounded_sum(matmul(h, wn.t(), prec), src, dst, n,
                                prec) / deg
        else:
            neigh = matmul(rounded_sum(h, src, dst, n, prec) / deg, wn.t(),
                           prec)
        h = matmul(h, ws.t(), prec) + neigh + params[f"sage{i}.bias"]
        if i != layers - 1:
            h = torch.relu(h)
            if masks is not None:
                h = h * masks[i]
    return h


def dropout_masks(cfg: dict, inputs, row_order):
    """One training step's dropout masks, drawn as the program's
    ``nn.Dropout`` draws them (one call a hidden layer, on a (nodes,
    hidden) float32 tensor of the run's device, from its default
    generator), then laid out in the reference's node order: row ``i`` of
    the program's layout is node ``row_order[i]``."""
    p = cfg["dropout"]
    if not p:
        return None
    n = inputs.num_nodes["_N"]
    dev = inputs.feats["_N"].device
    masks = []
    for _ in range(cfg["num_layers"] - 1):
        m = F.dropout(torch.ones((n, cfg["hidden_channels"]), device=dev), p,
                      training=True)
        if row_order is not None:
            m = torch.empty_like(m).index_copy_(0, row_order, m)
        masks.append(m)
    return masks


def work(cfg: dict, num_nodes: dict, edges: dict, mode: str) -> dict:
    """The model's operations in one forward (``infer``) or training step
    (``train``): 2 a multiply-add of each linear, 1 an edge-feature add of
    each aggregation, and the backward as autograd needs it (the input
    features take no gradient). ``aggs`` lists each aggregation's
    ``(relation, width, direction)``, the backward's as ``"bwd"``."""
    n, e = num_nodes["_N"], edges[HOMOGENEOUS]
    dims = _dims(cfg)
    flops, aggs = 0, []
    for i, (fi, fo) in enumerate(zip(dims, dims[1:])):
        lin = 2 * n * fi * fo  # one linear's forward, each of two
        before = fi > fo
        width = fo if before else fi
        flops += 2 * lin + e * width
        aggs.append((RELATION, width, "fwd"))
        if mode != "train":
            continue
        grad_in = i > 0  # the layer's input takes a gradient
        flops += 2 * lin  # both weights' gradients
        if grad_in:
            flops += 2 * lin  # both linears' input gradients
        if before or grad_in:  # the aggregated table takes a gradient
            flops += e * width
            aggs.append((RELATION, width, "bwd"))
    return {"flops": flops, "aggs": aggs}
