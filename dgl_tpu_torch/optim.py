"""Sparse-embedding optimisers (counterpart of ``dgl_tpu/optim.py``;
reference ``python/dgl/optim/``) over the row-sparse updates of
:mod:`dgl_tpu_torch.nn.sparse_emb`.

``step`` writes the new rows into each embedding's ``weight`` in place, so
every holder of the tensor sees them; rows that no id touched keep their
values exactly."""
import torch

from .nn.sparse_emb import (SparseAdagradState, SparseAdamState,
                            sparse_adagrad_init, sparse_adagrad_update,
                            sparse_adam_init, sparse_adam_update)

__all__ = [
    "SparseAdagradState",
    "SparseAdamState",
    "sparse_adagrad_init",
    "sparse_adagrad_update",
    "sparse_adam_init",
    "sparse_adam_update",
    "SparseGradOptimizer",
    "SparseAdagrad",
    "SparseAdam",
]


class SparseGradOptimizer:
    """Abstract base of the row-sparse optimisers (reference
    ``optim/pytorch/sparse_optim.py:24`` SparseGradOptimizer): holds the
    embedding list and defines the ``step(grads_per_emb)`` contract."""

    def __init__(self, params, lr: float):
        self.params = list(params)
        self.lr = lr

    def step(self, grads_per_emb):
        raise NotImplementedError

    def zero_grad(self):
        """No-op: gradients are passed into ``step``, not accumulated on
        the embeddings."""

    def _apply(self, update, grads_per_emb, **kw):
        """``grads_per_emb``: one ``(ids, grads)`` a embedding, in the
        order of construction."""
        with torch.no_grad():
            for i, (emb, (ids, grads)) in enumerate(
                    zip(self.params, grads_per_emb)):
                table, self._state[i] = update(
                    emb.weight, self._state[i], ids, grads, lr=self.lr, **kw)
                emb.weight.copy_(table)


class SparseAdagrad(SparseGradOptimizer):
    """(reference ``optim/pytorch/sparse_optim.py:509``): Adagrad state a
    embedding, row-sparse updates through ``step``."""

    def __init__(self, params, lr: float = 0.01, eps: float = 1e-10):
        super().__init__(params, lr)
        self.eps = eps
        self._state = [sparse_adagrad_init(p.weight) for p in self.params]

    def step(self, grads_per_emb):
        self._apply(sparse_adagrad_update, grads_per_emb, eps=self.eps)


class SparseAdam(SparseGradOptimizer):
    """(reference ``optim/pytorch/sparse_optim.py:647``)."""

    def __init__(self, params, lr: float = 0.001, betas=(0.9, 0.999),
                 eps: float = 1e-8):
        super().__init__(params, lr)
        self.betas = betas
        self.eps = eps
        self._state = [sparse_adam_init(p.weight) for p in self.params]

    def step(self, grads_per_emb):
        self._apply(sparse_adam_update, grads_per_emb, beta1=self.betas[0],
                    beta2=self.betas[1], eps=self.eps)
