"""GNNExplainer (counterpart of ``dgl_tpu/nn/explain/gnnexplainer.py``;
reference ``python/dgl/nn/pytorch/explain/gnnexplainer.py``): learn soft
edge and feature masks that keep the model's prediction, with size and
entropy regularisers.

The model is a callable ``model_fn(graph, feat, eweight) -> logits``
(the reference asks for the same ``eweight`` hook in ``forward``). The
initial masks come from ``np.random.default_rng(seed)``, as in the JAX
package, and ``torch.optim.Adam`` makes ``optax.adam``'s update; the masks
lie on ``feat``'s device.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ...graph import _asnumpy

__all__ = ["GNNExplainer"]


def _entropy(m: torch.Tensor) -> torch.Tensor:
    return (-m * torch.log(m + 1e-15)
            - (1 - m) * torch.log(1 - m + 1e-15)).mean()


def _pred_loss(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Minus the log-probability of ``target``: averaged over rows for
    (N, C) logits, at index ``target`` for (C,) logits."""
    logp = torch.log_softmax(logits, dim=-1)
    if logp.dim() == 2:
        return -logp.gather(-1, target[:, None]).mean()
    return -logp[target]


def _normal(rng, size, device) -> torch.Tensor:
    return torch.from_numpy(rng.normal(0, 0.1, size).astype(
        np.float32)).to(device)


def _adam_steps(params, loss_fn, lr: float, num_epochs: int):
    """``num_epochs`` Adam steps on the leaf tensors ``params``, from fresh
    optimiser state (``optax.adam(lr)``'s update)."""
    for p in params:
        p.requires_grad_(True)
    opt = torch.optim.Adam(params, lr=lr)
    for _ in range(num_epochs):
        opt.zero_grad(set_to_none=True)
        loss_fn().backward()
        opt.step()


class GNNExplainer:
    """(reference ``gnnexplainer.py:14``)."""

    def __init__(
        self,
        model_fn: Callable,
        num_hops: int,
        lr: float = 0.01,
        num_epochs: int = 100,
        alpha1: float = 0.005,
        alpha2: float = 1.0,
        beta1: float = 1.0,
        beta2: float = 0.1,
        log: bool = False,
        seed: int = 0,
    ):
        self.model_fn = model_fn
        self.num_hops = num_hops
        self.lr = lr
        self.num_epochs = num_epochs
        self.alpha1 = alpha1
        self.alpha2 = alpha2
        self.beta1 = beta1
        self.beta2 = beta2
        self.log = log
        self.seed = seed

    def _loss(self, masks, graph, feat, target):
        edge_mask, feat_mask = masks
        em = torch.sigmoid(edge_mask)
        fm = torch.sigmoid(feat_mask)
        logits = self.model_fn(graph, feat * fm[None, :], em)
        size_loss = (self.alpha1 * em.sum()
                     + self.alpha2 * fm.sum() / fm.shape[0])
        ent_loss = self.beta1 * _entropy(em) + self.beta2 * _entropy(fm)
        return _pred_loss(logits, target) + size_loss + ent_loss

    def _init_masks(self, graph, feat):
        rng = np.random.default_rng(self.seed)
        E = graph._relation(None).num_edges_padded
        return (_normal(rng, E, feat.device),
                _normal(rng, feat.shape[-1], feat.device))

    def _optimize(self, graph, feat, target):
        masks = self._init_masks(graph, feat)
        _adam_steps(masks, lambda: self._loss(masks, graph, feat, target),
                    self.lr, self.num_epochs)
        return (torch.sigmoid(masks[1].detach()),  # feat mask
                torch.sigmoid(masks[0].detach()))  # edge mask

    def _target(self, graph, feat):
        with torch.no_grad():
            logits = self.model_fn(graph, feat, torch.ones(
                graph._relation(None).num_edges_padded, device=feat.device))
        return torch.argmax(logits, dim=-1)

    def explain_node(self, node_id, graph, feat, **kwargs):
        """Returns (new_node_id, subgraph, feat_mask, edge_mask)
        (reference ``gnnexplainer.py:175``); the subgraph is ``node_id``'s
        ``num_hops`` in-neighbourhood, and the loss averages over all of
        its nodes, as the JAX package's does."""
        from ...subgraph import khop_in_subgraph

        sg, inv = khop_in_subgraph(graph, [int(node_id)], self.num_hops)
        sub_feat = feat[sg.ndata["_ID"].to(feat.device)]
        target = self._target(sg, sub_feat)
        feat_mask, edge_mask = self._optimize(sg, sub_feat, target)
        return int(_asnumpy(inv)[0]), sg, feat_mask, edge_mask

    def explain_graph(self, graph, feat, **kwargs):
        """Returns (feat_mask, edge_mask) for a graph-level prediction
        (reference ``gnnexplainer.py:327``)."""
        target = self._target(graph, feat)
        if target.dim() == 0:
            target = target[None]
        return self._optimize(graph, feat, target)
