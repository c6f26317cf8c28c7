"""HeteroGNNExplainer (counterpart of
``dgl_tpu/nn/explain/hetero_gnnexplainer.py``; reference
``python/dgl/nn/pytorch/explain/heterognnexplainer.py``): GNNExplainer
with a feature mask a node type and an edge mask a canonical edge type.

The model is a callable ``model_fn(graph, feat_dict, eweight_dict) ->
logits``. Masks as in ``GNNExplainer``: drawn from
``np.random.default_rng(seed)`` (the edge types first, in
``graph.canonical_etypes`` order, then the features' types), trained with
``torch.optim.Adam``.
"""
from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from ...graph import _asnumpy
from .gnnexplainer import _adam_steps, _entropy, _normal, _pred_loss

__all__ = ["HeteroGNNExplainer"]


class HeteroGNNExplainer:
    """(reference ``heterognnexplainer.py:13``)."""

    def __init__(self, model_fn: Callable, num_hops: int, lr: float = 0.01,
                 num_epochs: int = 100, alpha1: float = 0.005,
                 alpha2: float = 1.0, beta1: float = 1.0, beta2: float = 0.1,
                 seed: int = 0):
        self.model_fn = model_fn
        self.num_hops = num_hops
        self.lr = lr
        self.num_epochs = num_epochs
        self.alpha1 = alpha1
        self.alpha2 = alpha2
        self.beta1 = beta1
        self.beta2 = beta2
        self.seed = seed

    def _loss(self, masks, graph, feat, target, target_row=None):
        emasks, fmasks = masks
        em = {k: torch.sigmoid(v) for k, v in emasks.items()}
        fm = {k: torch.sigmoid(v) for k, v in fmasks.items()}
        masked_feat = {nt: feat[nt] * fm[nt][None, :] for nt in feat}
        logits = self.model_fn(graph, masked_feat, em)
        if target_row is not None:
            logits = logits[target_row]
        size_loss = sum(self.alpha1 * v.sum() for v in em.values())
        size_loss += sum(
            self.alpha2 * v.sum() / v.shape[0] for v in fm.values()
        )
        ent_loss = sum(self.beta1 * _entropy(v) for v in em.values())
        ent_loss += sum(self.beta2 * _entropy(v) for v in fm.values())
        return _pred_loss(logits, target) + size_loss + ent_loss

    def _init_masks(self, graph, feat: Dict):
        rng = np.random.default_rng(self.seed)
        dev = next(iter(feat.values())).device
        emasks = {cet: _normal(rng, graph._relations[cet].num_edges_padded,
                               dev)
                  for cet in graph.canonical_etypes}
        fmasks = {nt: _normal(rng, feat[nt].shape[-1], dev) for nt in feat}
        return emasks, fmasks

    def _optimize(self, graph, feat: Dict, target, target_row=None):
        masks = self._init_masks(graph, feat)
        _adam_steps(
            [*masks[0].values(), *masks[1].values()],
            lambda: self._loss(masks, graph, feat, target, target_row),
            self.lr, self.num_epochs)
        return ({nt: torch.sigmoid(v.detach()) for nt, v in masks[1].items()},
                {cet: torch.sigmoid(v.detach())
                 for cet, v in masks[0].items()})

    def _logits(self, g, feat: Dict):
        dev = next(iter(feat.values())).device
        with torch.no_grad():
            return self.model_fn(g, feat, {
                cet: torch.ones(g._relations[cet].num_edges_padded,
                                device=dev)
                for cet in g.canonical_etypes})

    def explain_node(self, ntype, node_id, graph, feat: Dict, **kwargs):
        """Returns (new_node_id, subgraph, feat_mask_dict, edge_mask_dict)
        (reference ``heterognnexplainer.py:83``); the node types without a
        node in the subgraph get no feature mask."""
        from ...subgraph import khop_in_subgraph

        sg, inv = khop_in_subgraph(
            graph, {ntype: [int(node_id)]}, self.num_hops
        )
        sub_feat = {
            nt: feat[nt][sg._node_frames[nt]["_ID"].to(feat[nt].device)]
            for nt in feat if nt in sg.ntypes and sg.num_nodes(nt) > 0
        }
        new_id = int(_asnumpy(inv[ntype] if isinstance(inv, dict)
                              else inv)[0])
        target = torch.argmax(self._logits(sg, sub_feat)[new_id])
        fm, em = self._optimize(sg, sub_feat, target, target_row=new_id)
        return new_id, sg, fm, em

    def explain_graph(self, graph, feat: Dict, **kwargs):
        """Returns (feat_mask_dict, edge_mask_dict) (reference
        ``heterognnexplainer.py:216``)."""
        target = torch.argmax(self._logits(graph, feat), dim=-1)
        if target.dim() == 0:
            target = target[None]
        return self._optimize(graph, feat, target)
