"""The program's side of each configuration family, one module a family:
``build(cfg, inputs, weights, device) -> System`` builds the graph, its
plans and the model through ``dgl_tpu_torch``'s normal entry points, and
loads the benchmark's weights into the model.

These modules alone import the program. ``cold_tail`` reads what the
B1 roofline needs from a hub plan.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch


@dataclass
class System:
    """The system under test as the harness drives it: ``forward()`` gives
    the logits that the loss takes (``labels``, ``train_mask`` in the same
    row order); row ``i`` of them is the reference's node
    ``row_order[i]`` (None: the same order). ``plans`` maps a relation's
    name to its hub plan."""
    model: torch.nn.Module
    forward: Callable[[], torch.Tensor]
    labels: torch.Tensor
    train_mask: torch.Tensor
    row_order: Optional[torch.Tensor]
    plans: dict


def load_weights(model: torch.nn.Module, weights: dict) -> None:
    """Copy the benchmark's weights into the model; every parameter must
    get one of its own shape."""
    params = dict(model.named_parameters())
    if set(params) != set(weights):
        raise RuntimeError(f"the model's parameters {sorted(params)} are not "
                           f"the benchmark's {sorted(weights)}")
    with torch.no_grad():
        for name, p in params.items():
            if p.shape != weights[name].shape:
                raise RuntimeError(f"{name}: shape {tuple(p.shape)}, the "
                                   f"benchmark's {tuple(weights[name].shape)}")
            p.copy_(weights[name])


def check_hub_plans(graph) -> dict:
    """The hub plan of each relation, which must carry its sums alone (no
    bitmap plan, no dense mask, no full-edge shell plan)."""
    plans = {}
    for cet, rel in graph._relations.items():
        if (rel.hub_plan is None or rel.bitmap_plan is not None
                or rel.dense_adj is not None or rel.shell_plan is not None):
            raise RuntimeError(f"{cet}: the plans are not the hub plan alone")
        plans[cet[1]] = rel.hub_plan
    return plans


def cold_tail(plan, reverse: bool) -> Optional[dict]:
    """What B1 sums in one direction of a hub plan (the forward's shells,
    or with ``reverse`` the backward's): its edges (the cold edges within
    the shell levels; those beyond enter as the residual base), the
    distinct table rows they read, the output rows, whether a residual
    base is read, and the bytes of a gathered value. None when the
    direction has no shell level (B1 does not run)."""
    shells = plan.rev_shells if reverse else plan.shells
    if not shells:
        return None
    idx = torch.cat([i[m[:, 0] > 0] for i, m in shells])
    *_, res, _unrank, n_out = plan.direction(reverse)
    return {"edges": int(idx.numel()),
            "rows": int(torch.unique(idx).numel()),
            "n_out": int(n_out),
            "base": res is not None and int(res[1].shape[0]) > 0,
            "elem": 2 if plan.cold == "shell" else 4}
