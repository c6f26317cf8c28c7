"""The R-GCN of DGL's ``examples/pytorch/rgcn-hetero``: per layer, one
``GraphConv(norm="both")`` a relation, summed by destination type
(``HeteroGraphConv(aggregate="sum")``), ReLU between the layers; the
loss is on the target type's logits.

``GraphConv``: the source rows times ``1 / sqrt(out-degree)``, projected
before the sum where the layer narrows (``in > out``), else after it; the
sum times ``1 / sqrt(in-degree)`` (degrees clamped at 1), plus the bias. A
relation whose source type has no input in a layer is left out, as
``HeteroGraphConv`` leaves it out. Parameter names are the program's
``state_dict`` names; a weight is (in, out).
"""
from __future__ import annotations

import torch

from ..inputs import relations
from .common import (BIAS_BOUND, Precision, degrees, matmul, rounded_sum,
                     xavier_bound)


def _dims(cfg: dict) -> list:
    hidden = [cfg["hidden_channels"]] * (cfg["num_layers"] - 1)
    return [cfg["in_channels"]] + hidden + [cfg["out_channels"]]


def _relations(cfg: dict) -> list:
    return relations(cfg["graph"])


def _layers(cfg: dict, types) -> list:
    """Per layer, the relations that run: those whose source type has an
    input (every type has one in layer 0)."""
    have, out = set(types), []
    for _ in range(cfg["num_layers"]):
        rels = [r for r in _relations(cfg) if r[0] in have]
        out.append(rels)
        have = {r[2] for r in rels}
    return out


def param_shapes(cfg: dict) -> dict:
    dims, out = _dims(cfg), {}
    for i, (fi, fo) in enumerate(zip(dims, dims[1:])):
        for _st, et, _dt in _relations(cfg):
            out[f"layer{i}.mods.{et}.weight"] = ((fi, fo),
                                                 xavier_bound(fi, fo))
            out[f"layer{i}.mods.{et}.bias"] = ((fo,), BIAS_BOUND)
    return out


def forward(cfg: dict, params: dict, inputs, prec: Precision, masks=None):
    """The target type's logits."""
    n = inputs.num_nodes
    h = dict(inputs.feats)
    layers = _layers(cfg, h)
    for i, rels in enumerate(layers):
        outs = {}
        for st, et, dt in rels:
            src, dst = inputs.relations[(st, et, dt)]
            w = params[f"layer{i}.mods.{et}.weight"]
            norm_src = degrees(src, n[st]).clamp_(min=1).sqrt_().reciprocal_()
            norm_dst = degrees(dst, n[dt]).clamp_(min=1).sqrt_().reciprocal_()
            fs = h[st] * norm_src.unsqueeze(1)
            if w.shape[0] > w.shape[1]:
                rst = rounded_sum(matmul(fs, w, prec), src, dst, n[dt], prec)
            else:
                rst = matmul(rounded_sum(fs, src, dst, n[dt], prec), w, prec)
            bias = params[f"layer{i}.mods.{et}.bias"]
            rst = rst * norm_dst.unsqueeze(1) + bias
            outs.setdefault(dt, []).append(rst)
        h = {dt: sum(v[1:], v[0]) for dt, v in outs.items()}
        if i != len(layers) - 1:
            h = {dt: torch.relu(v) for dt, v in h.items()}
    return h[cfg["graph"]["target"]]


def dropout_masks(cfg: dict, inputs, row_order):
    return None  # the model has no dropout


def work(cfg: dict, num_nodes: dict, edges: dict, mode: str) -> dict:
    """As ``sage.work``: the model's operations and its aggregations.
    Only the relations whose output reaches the loss take a backward."""
    dims = _dims(cfg)
    layers = _layers(cfg, num_nodes)
    need = {cfg["graph"]["target"]}
    back = []
    for i in reversed(range(len(layers))):
        rels = [r for r in layers[i] if r[2] in need]
        back.insert(0, set(rels))
        need = {r[0] for r in rels}
    flops, aggs = 0, []
    for i, rels in enumerate(layers):
        fi, fo = dims[i], dims[i + 1]
        for cet in rels:
            st, et, dt = cet
            e = edges[cet]
            before = fi > fo
            lin = 2 * (num_nodes[st] if before else num_nodes[dt]) * fi * fo
            width = fo if before else fi
            flops += lin + e * width
            aggs.append((et, width, "fwd"))
            if mode != "train" or cet not in back[i]:
                continue
            grad_in = i > 0
            flops += lin * (2 if grad_in else 1)  # the weight's; the input's
            if before or grad_in:
                flops += e * width
                aggs.append((et, width, "bwd"))
    return {"flops": flops, "aggs": aggs}
