"""Parameterized Explainer (counterpart of
``dgl_tpu/nn/explain/pgexplainer.py``; reference
``python/dgl/nn/pytorch/explain/pgexplainer.py``): an MLP over the
concatenated embeddings of an edge's endpoints predicts the edge's
importance; trained once, it explains any instance.

The training mask is the concrete (Gumbel) relaxation of that importance.
Its uniform noise is drawn from a ``torch.Generator`` seeded with ``seed``
on the CPU and moved to the device, so a run on the card and one on the
CPU see the same noise (JAX's key stream cannot be reproduced, so it is
not the JAX package's noise).
"""
from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from .._init import dense
from ..utils_nn import _clamped

__all__ = ["PGExplainer"]


class _ExplainNet(nn.Module):
    """``fc0`` (to ``hidden``), ReLU, ``fc1`` (to one logit): the JAX
    package's flax ``_ExplainNet``, whose parameters
    ``params.from_flax_params`` maps onto it."""

    def __init__(self, in_feats: int, hidden: int = 64, generator=None):
        super().__init__()
        self.fc0 = dense(in_feats, hidden, generator=generator)
        self.fc1 = dense(hidden, 1, generator=generator)

    def forward(self, edge_emb):
        return self.fc1(torch.relu(self.fc0(edge_emb)))[..., 0]


def _uniform_noise(gen: torch.Generator, shape, device) -> torch.Tensor:
    """Uniform draws in ``[1e-6, 1 - 1e-6)`` from the CPU generator
    ``gen``, on ``device``."""
    return (torch.rand(shape, generator=gen) * (1 - 2e-6) + 1e-6).to(device)


def _concrete(logits, u, temperature):
    """The concrete relaxation of ``sigmoid(logits)`` under the uniform
    noise ``u``."""
    return torch.sigmoid((logits + (torch.log(u) - torch.log(1 - u)))
                         / temperature)


def _mask_loss(logits, pred_label, mask, coff_budget, coff_connect):
    """Cross-entropy of the predicted labels plus the mask's size and
    entropy terms (reference ``pgexplainer.py:146-175``)."""
    logp = torch.atleast_2d(torch.log_softmax(logits, dim=-1))
    ce = -logp.gather(-1, torch.atleast_1d(pred_label)[:, None]).mean()
    m = torch.clamp(mask, 1e-6, 1 - 1e-6)
    ent = (-m * torch.log(m) - (1 - m) * torch.log(1 - m)).mean()
    return ce + coff_budget * mask.mean() + coff_connect * ent


class PGExplainer:
    """(reference ``pgexplainer.py:17``).

    ``model_fn(graph, feat, eweight) -> (logits, node_emb)``;
    ``num_features`` is ``node_emb``'s width. The explainer's MLP is drawn
    from seed ``seed`` as flax's ``Dense`` layers are, on the CPU, and
    moves to the embeddings' device at ``train_step``.
    """

    def __init__(self, model_fn: Callable, num_features: int,
                 num_hops: int = 1, coff_budget: float = 0.01,
                 coff_connect: float = 5e-4, sample_bias: float = 0.0,
                 lr: float = 0.01, epochs: int = 20, seed: int = 0):
        self.model_fn = model_fn
        self.num_hops = num_hops
        self.coff_budget = coff_budget
        self.coff_connect = coff_connect
        self.lr = lr
        self.epochs = epochs
        self.seed = seed
        self.net = _ExplainNet(2 * num_features, generator=torch.Generator(
        ).manual_seed(seed))

    def _edge_emb(self, graph, node_emb):
        rel = graph._relation(None)
        return torch.cat([
            node_emb.index_select(0, _clamped(rel.src, rel.num_src)),
            node_emb.index_select(0, _clamped(rel.dst, rel.num_dst))], -1)

    def _ones(self, graph, device):
        return torch.ones(graph._relation(None).num_edges_padded,
                          device=device)

    def train_step(self, graph, feat, temperature=1.0):
        """``epochs`` Adam steps of the MLP over the (single) instance
        ``graph``; returns the last epoch's loss."""
        with torch.no_grad():
            logits0, emb = self.model_fn(graph, feat,
                                         self._ones(graph, feat.device))
            pred_label = torch.argmax(logits0, dim=-1)
            eemb = self._edge_emb(graph, emb)
        self.net.to(eemb.device)
        opt = torch.optim.Adam(self.net.parameters(), lr=self.lr)
        gen = torch.Generator().manual_seed(self.seed)
        loss = None
        for _ in range(self.epochs):
            opt.zero_grad(set_to_none=True)
            elogits = self.net(eemb)
            mask = _concrete(elogits, _uniform_noise(
                gen, elogits.shape, elogits.device), temperature)
            logits, _ = self.model_fn(graph, feat, mask)
            loss = _mask_loss(logits, pred_label, mask, self.coff_budget,
                              self.coff_connect)
            loss.backward()
            opt.step()
        return loss.item()

    @torch.no_grad()
    def explain_graph(self, graph, feat):
        """Returns (probs, edge_weight) (reference ``pgexplainer.py:252``)."""
        _, emb = self.model_fn(graph, feat, self._ones(graph, feat.device))
        mask = torch.sigmoid(self.net(self._edge_emb(graph, emb)))
        logits, _ = self.model_fn(graph, feat, mask)
        return torch.softmax(logits, dim=-1), mask
