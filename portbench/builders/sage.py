"""GraphSAGE on one homogeneous graph relabelled by the hub plan:
``dgl_tpu_torch.graph`` → ``transforms.reorder_for_spmm`` (the hub plan:
int8 counts, the shell cold tail through kernel B1) →
``models.GraphSAGE``. The features, labels and train mask ride on the
graph's node data, so the relabelling permutes them as a user's would."""
from __future__ import annotations

import torch

from . import System, check_hub_plans, load_weights


def build(cfg: dict, inputs, weights: dict, device) -> System:
    import dgl_tpu_torch as dt
    from dgl_tpu_torch.models import GraphSAGE

    (src, dst), = inputs.relations.values()
    g = dt.graph((src, dst), num_nodes=inputs.num_nodes["_N"], device=device)
    g.ndata["feat"] = inputs.feats["_N"]
    g.ndata["label"] = inputs.labels
    g.ndata["train_mask"] = inputs.train_mask
    plan = cfg["plan"]
    gp, perm = dt.transforms.reorder_for_spmm(
        g, num_hubs=plan["num_hubs"], precision=plan["precision"])
    plans = check_hub_plans(gp)
    model = GraphSAGE(cfg["in_channels"], cfg["hidden_channels"],
                      cfg["out_channels"], num_layers=cfg["num_layers"],
                      aggregator_type=cfg["aggr"], dropout=cfg["dropout"],
                      generator=torch.Generator().manual_seed(0),
                      device=device)
    load_weights(model, weights)
    x = gp.ndata["feat"]
    return System(model=model, forward=lambda: model(gp, x),
                  labels=gp.ndata["label"],
                  train_mask=gp.ndata["train_mask"],
                  row_order=torch.as_tensor(perm, device=x.device),
                  plans=plans)
