"""Shallow network embeddings (counterpart of ``dgl_tpu/nn/network_emb.py``;
reference ``python/dgl/nn/pytorch/network_emb.py``): DeepWalk and
MetaPath2Vec, skip-gram with negative sampling over random walks.

The walks and the (target, context, negative) batches are drawn on the
host (``sampling.random_walk``) from the caller's numpy generator, in the
reference's order; the loss is one ``torch`` step over two
``nn.Embedding`` tables, ``node_embed`` (uniform in [0, 1)) and
``context_embed`` (zeros), as the reference names them (``from_flax_params``
carries its tables across).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..graph import Graph
from ..sampling.randomwalks import _walk_host

__all__ = ["DeepWalk", "MetaPath2Vec"]


def _skipgram_pairs(traces: np.ndarray, window: int):
    """Every (target, context) pair of the -1-padded walks within
    ``window`` steps, walk by walk, target by target, context in step
    order (the reference's loops, vectorised)."""
    n, L = traces.shape
    lengths = (traces >= 0).sum(1)
    d = np.array([k for k in range(-window, window + 1) if k], np.int64)
    i = np.arange(L)[:, None]
    j = i + d[None, :]                                       # (L, 2w)
    ok = ((j >= 0) & (j < L))[None] & (i[None] < lengths[:, None, None]) \
        & (j[None] < lengths[:, None, None])                 # (n, L, 2w)
    rows = np.broadcast_to(np.arange(n)[:, None, None], ok.shape)[ok]
    ii = np.broadcast_to(i[None], ok.shape)[ok]
    jj = np.broadcast_to(j[None], ok.shape)[ok]
    return traces[rows, ii], traces[rows, jj]


class _SkipGram(nn.Module):
    def __init__(self, num_nodes: int, emb_dim: int, neg_weight: float,
                 generator: Optional[torch.Generator], device):
        super().__init__()
        self.node_embed = nn.Embedding(num_nodes, emb_dim, device=device)
        self.context_embed = nn.Embedding(num_nodes, emb_dim, device=device)
        with torch.no_grad():
            self.node_embed.weight.copy_(torch.rand(
                (num_nodes, emb_dim), generator=generator))
            self.context_embed.weight.zero_()
        self.neg_weight = neg_weight

    @property
    def _device(self):
        return self.node_embed.weight.device

    def forward(self, targets, contexts, negatives):
        """The skip-gram loss: ``-log sigmoid(t . c)`` over the pairs plus
        ``neg_weight`` times ``-log sigmoid(-t . n)`` over the negatives,
        each a mean."""
        t = self.node_embed(targets)
        pos = (t * self.context_embed(contexts)).sum(-1)
        neg = (t[:, None, :] * self.context_embed(negatives)).sum(-1)
        return (-F.logsigmoid(pos).mean()
                - F.logsigmoid(-neg).mean() * self.neg_weight)

    def _batch(self, traces, num_nodes, window, negative_size, rng):
        tgt, ctx = _skipgram_pairs(traces, window)
        negs = rng.integers(0, num_nodes, (tgt.shape[0], negative_size))

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a, np.int64)).to(
                self._device)

        return put(tgt), put(ctx), put(negs)


class DeepWalk(_SkipGram):
    """(reference ``network_emb.py:21``). ``sample_batch(g, seeds, rng)``
    draws a batch of (target, context, negative) ids from walks of
    ``walk_length`` steps (int64 on the module's device); calling the
    module on them gives the loss. ``sparse`` is kept for the reference's
    signature (the gradients are dense)."""

    def __init__(self, num_nodes: int, emb_dim: int = 128,
                 walk_length: int = 40, window_size: int = 5,
                 neg_weight: float = 1.0, negative_size: int = 1,
                 sparse: bool = True,
                 generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__(num_nodes, emb_dim, neg_weight, generator, device)
        self.num_nodes = num_nodes
        self.emb_dim = emb_dim
        self.walk_length = walk_length
        self.window_size = window_size
        self.negative_size = negative_size
        self.sparse = sparse

    def sample_batch(self, g: Graph, seeds, rng: np.random.Generator):
        traces, _, _ = _walk_host(g, seeds, length=self.walk_length,
                                  seed=int(rng.integers(2**31)))
        return self._batch(traces, self.num_nodes, self.window_size,
                           self.negative_size, rng)


class MetaPath2Vec(_SkipGram):
    """(reference ``network_emb.py:231``): DeepWalk over metapath walks on
    a heterograph, one table over every node (a type's ids offset by the
    counts of the types before it)."""

    def __init__(self, num_nodes_total: int, emb_dim: int = 128,
                 window_size: int = 5, negative_size: int = 5,
                 generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__(num_nodes_total, emb_dim, 1.0, generator, device)
        self.num_nodes_total = num_nodes_total
        self.emb_dim = emb_dim
        self.window_size = window_size
        self.negative_size = negative_size

    @staticmethod
    def type_offsets(g: Graph):
        """Each node type's first global id, and the total count."""
        offs, total = {}, 0
        for nt in g.ntypes:
            offs[nt] = total
            total += g.num_nodes(nt)
        return offs, total

    def sample_batch(self, g: Graph, seeds, metapath,
                     rng: np.random.Generator):
        offs, _ = MetaPath2Vec.type_offsets(g)
        traces, types, _ = _walk_host(g, seeds, metapath=metapath,
                                      return_eids=True,
                                      seed=int(rng.integers(2**31)))
        step_off = np.array([offs[g.ntypes[int(t)]] for t in types],
                            np.int64)
        glob = np.where(traces >= 0, traces + step_off[None, :], -1)
        return self._batch(glob, self.num_nodes_total, self.window_size,
                           self.negative_size, rng)
