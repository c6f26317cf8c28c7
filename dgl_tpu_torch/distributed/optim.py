"""Distributed sparse-embedding optimisers (counterpart of
``dgl_tpu/distributed/optim.py``; reference
``python/dgl/distributed/optim/pytorch/sparse_optim.py:24,465,509,647``).

The reference pushes sparse gradients into the KVStore over RPC; here the
table is a :class:`~.dist_tensor.DistEmbedding` and the row-sparse update
is ``nn/sparse_emb.py``'s: only touched rows move.
"""
from __future__ import annotations

from typing import List

import torch

from ..nn.sparse_emb import (sparse_adagrad_init, sparse_adagrad_update,
                             sparse_adam_init, sparse_adam_update)
from .dist_tensor import DistEmbedding

__all__ = ["DistSparseGradOptimizer", "SparseAdagrad", "SparseAdam"]


def _on(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x).to(like.device)


class DistSparseGradOptimizer:
    """Abstract base (reference ``sparse_optim.py:24``): holds the
    DistEmbedding list; ``step([(ids, grads), ...])`` applies a row-sparse
    update to each."""

    def __init__(self, params: List[DistEmbedding], lr: float):
        self.params = list(params)
        self.lr = lr
        for p in self.params:
            if not isinstance(p, DistEmbedding):
                raise TypeError(
                    "DistSparseGradOptimizer expects DistEmbedding params")

    def step(self, grads_per_emb):
        raise NotImplementedError

    def zero_grad(self):
        """The gradients are handed to ``step``: nothing to clear."""


class SparseAdagrad(DistSparseGradOptimizer):
    """(reference ``sparse_optim.py:465``)."""

    def __init__(self, params, lr: float = 0.01, eps: float = 1e-10):
        super().__init__(params, lr)
        self.eps = eps
        self._state = [sparse_adagrad_init(p.data) for p in self.params]

    def step(self, grads_per_emb):
        for i, (emb, (ids, grads)) in enumerate(
                zip(self.params, grads_per_emb)):
            emb._data, self._state[i] = sparse_adagrad_update(
                emb.data, self._state[i], _on(ids, emb.data),
                _on(grads, emb.data), lr=self.lr, eps=self.eps)


class SparseAdam(DistSparseGradOptimizer):
    """(reference ``sparse_optim.py:647``)."""

    def __init__(self, params, lr: float = 0.001, betas=(0.9, 0.999),
                 eps: float = 1e-8):
        super().__init__(params, lr)
        self.betas = betas
        self.eps = eps
        self._state = [sparse_adam_init(p.data) for p in self.params]

    def step(self, grads_per_emb):
        for i, (emb, (ids, grads)) in enumerate(
                zip(self.params, grads_per_emb)):
            emb._data, self._state[i] = sparse_adam_update(
                emb.data, self._state[i], _on(ids, emb.data),
                _on(grads, emb.data), lr=self.lr, beta1=self.betas[0],
                beta2=self.betas[1], eps=self.eps)
