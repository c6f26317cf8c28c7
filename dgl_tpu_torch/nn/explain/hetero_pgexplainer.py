"""HeteroPGExplainer (counterpart of
``dgl_tpu/nn/explain/hetero_pgexplainer.py``; reference
``python/dgl/nn/pytorch/explain/heteropgexplainer.py``): the
parameterized explainer over heterographs. One shared MLP scores every
edge from its endpoints' embeddings, a canonical edge type at a time.

``model_fn(graph, feat_dict, eweight_dict) -> (logits, node_emb_dict)``.
The noise comes as ``PGExplainer``'s does, one draw an edge type an
epoch, in ``graph.canonical_etypes`` order.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

from ..utils_nn import _clamped
from .pgexplainer import _concrete, _ExplainNet, _mask_loss, _uniform_noise

__all__ = ["HeteroPGExplainer"]


class HeteroPGExplainer:
    """(reference ``heteropgexplainer.py:14``)."""

    def __init__(self, model_fn: Callable, num_features: int,
                 coff_budget: float = 0.01, coff_connect: float = 5e-4,
                 lr: float = 0.01, epochs: int = 20, seed: int = 0):
        self.model_fn = model_fn
        self.coff_budget = coff_budget
        self.coff_connect = coff_connect
        self.lr = lr
        self.epochs = epochs
        self.seed = seed
        self.net = _ExplainNet(2 * num_features, generator=torch.Generator(
        ).manual_seed(seed))

    def _ones(self, g, device):
        return {cet: torch.ones(g._relations[cet].num_edges_padded,
                                device=device)
                for cet in g.canonical_etypes}

    def _edge_emb(self, graph, node_emb: Dict):
        out = {}
        for cet in graph.canonical_etypes:
            st, _, dt = cet
            rel = graph._relations[cet]
            out[cet] = torch.cat([
                node_emb[st].index_select(0, _clamped(rel.src, rel.num_src)),
                node_emb[dt].index_select(0, _clamped(rel.dst, rel.num_dst))],
                -1)
        return out

    def train_step(self, graph, feat: Dict, temperature: float = 1.0):
        """``epochs`` Adam steps of the MLP; returns the last loss."""
        dev = next(iter(feat.values())).device
        with torch.no_grad():
            logits0, emb = self.model_fn(graph, feat, self._ones(graph, dev))
            pred_label = torch.argmax(logits0, dim=-1)
            eemb = self._edge_emb(graph, emb)
        self.net.to(dev)
        opt = torch.optim.Adam(self.net.parameters(), lr=self.lr)
        gen = torch.Generator().manual_seed(self.seed)
        loss = None
        for _ in range(self.epochs):
            opt.zero_grad(set_to_none=True)
            masks = {}
            for cet, e in eemb.items():
                elogits = self.net(e)
                masks[cet] = _concrete(elogits, _uniform_noise(
                    gen, elogits.shape, dev), temperature)
            logits, _ = self.model_fn(graph, feat, masks)
            flat = torch.cat([m.reshape(-1) for m in masks.values()])
            loss = _mask_loss(logits, pred_label, flat, self.coff_budget,
                              self.coff_connect)
            loss.backward()
            opt.step()
        return loss.item()

    @torch.no_grad()
    def explain_graph(self, graph, feat: Dict):
        """Returns (probs, {etype: edge_weight}) (reference
        ``heteropgexplainer.py:201``)."""
        dev = next(iter(feat.values())).device
        _, emb = self.model_fn(graph, feat, self._ones(graph, dev))
        masks = {cet: torch.sigmoid(self.net(e))
                 for cet, e in self._edge_emb(graph, emb).items()}
        logits, _ = self.model_fn(graph, feat, masks)
        return torch.softmax(logits, dim=-1), masks
