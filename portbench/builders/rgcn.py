"""The R-GCN of ``dgl_tpu_torch.examples.rgcn_hetero.HeteroRGCN`` (one
``GraphConv`` a relation in ``HeteroGraphConv(aggregate="sum")``) over
``dgl_tpu_torch.heterograph(...).with_spmm_plans(...)``: a hub plan on
every relation, B1 on the cold tails (bipartite relations included)."""
from __future__ import annotations

import torch

from . import System, check_hub_plans, load_weights


def build(cfg: dict, inputs, weights: dict, device) -> System:
    import dgl_tpu_torch as dt
    from dgl_tpu_torch.examples.rgcn_hetero import HeteroRGCN

    g = dt.heterograph(dict(inputs.relations), dict(inputs.num_nodes),
                       device=device)
    gp = g.with_spmm_plans(**cfg["plan"])
    plans = check_hub_plans(gp)
    model = HeteroRGCN(cfg["in_channels"], cfg["hidden_channels"],
                       cfg["out_channels"], tuple(g.etypes),
                       generator=torch.Generator().manual_seed(0),
                       device=device)
    load_weights(model, weights)
    x = dict(inputs.feats)
    target = inputs.target
    return System(model=model, forward=lambda: model(gp, x)[target],
                  labels=inputs.labels, train_mask=inputs.train_mask,
                  row_order=None, plans=plans)
