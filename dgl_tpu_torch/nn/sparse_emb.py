"""Trainable node embeddings with row-sparse optimisers (counterpart of
``dgl_tpu/nn/sparse_emb.py``; reference
``python/dgl/nn/pytorch/sparse_emb.py`` NodeEmbedding and
``python/dgl/optim/pytorch/sparse_optim.py`` SparseAdam/SparseAdagrad).

The table is a plain tensor. An update sums the batch's gradients per row
(repeated ids add up, as the reference's unique + sum) and counts the
touches with ``index_add_``; only touched rows move.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

__all__ = ["NodeEmbedding", "SparseAdagradState", "sparse_adagrad_init",
           "sparse_adagrad_update", "SparseAdamState", "sparse_adam_init",
           "sparse_adam_update"]


class NodeEmbedding:
    """(reference ``sparse_emb.py:14``). A handle on an embedding table,
    uniform in [-1, 1) from numpy's ``default_rng(seed)`` (the reference's
    draw), or ``init_func`` of a zero table. ``__call__`` gathers rows."""

    def __init__(self, num_embeddings, embedding_dim, name="emb",
                 init_func=None, seed=0, device="cuda"):
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.name = name
        if init_func is not None:
            self.weight = init_func(torch.zeros(
                (num_embeddings, embedding_dim), dtype=torch.float32,
                device=device))
        else:
            rng = np.random.default_rng(seed)
            self.weight = torch.from_numpy(rng.uniform(
                -1, 1, (num_embeddings, embedding_dim)).astype(
                    np.float32)).to(device)

    def __call__(self, node_ids, device=None):
        out = self.weight.index_select(0, node_ids.to(torch.int64))
        return out if device is None else out.to(device)


def _row_sums(table, ids, grads):
    """The per-row gradient sum (N, D) and touch count (N, 1)."""
    ids = ids.to(torch.int64)
    g = torch.zeros_like(table).index_add_(0, ids, grads.to(table.dtype))
    touched = table.new_zeros((table.shape[0], 1)).index_add_(
        0, ids, table.new_ones((ids.shape[0], 1)))
    return g, touched


class SparseAdagradState(NamedTuple):
    sum_sq: torch.Tensor  # (N, 1): the reference keeps a scalar a row


def sparse_adagrad_init(table):
    return SparseAdagradState(table.new_zeros((table.shape[0], 1)))


def sparse_adagrad_update(table, state, ids, grads, lr=0.01, eps=1e-10):
    """Row-sparse Adagrad (reference ``sparse_optim.py:465``): each row's
    accumulator adds the mean square of its summed gradient. ``ids``
    (B,), ``grads`` (B, D). Returns the new table and state."""
    g, touched = _row_sums(table, ids, grads)
    sum_sq = state.sum_sq + (g * g).mean(1, keepdim=True)
    update = -lr * g / (torch.sqrt(sum_sq) + eps)
    table = table + torch.where(touched > 0, update, 0.0)
    return table, SparseAdagradState(sum_sq)


class SparseAdamState(NamedTuple):
    m: torch.Tensor
    v: torch.Tensor
    t: torch.Tensor  # (N, 1) step counts a row (the reference's state_step)


def sparse_adam_init(table):
    return SparseAdamState(torch.zeros_like(table), torch.zeros_like(table),
                           table.new_zeros((table.shape[0], 1)))


def sparse_adam_update(table, state, ids, grads, lr=0.01, beta1=0.9,
                       beta2=0.999, eps=1e-8):
    """Row-sparse Adam with a step count a row (reference
    ``sparse_optim.py:647``): only touched rows advance their moments,
    count and values. Returns the new table and state."""
    g, touched = _row_sums(table, ids, grads)
    hit = touched > 0
    t = state.t + hit.to(table.dtype)
    m = torch.where(hit, beta1 * state.m + (1 - beta1) * g, state.m)
    v = torch.where(hit, beta2 * state.v + (1 - beta2) * g * g, state.v)
    t_safe = t.clamp_min(1.0)
    mhat = m / (1 - beta1 ** t_safe)
    vhat = v / (1 - beta2 ** t_safe)
    update = -lr * mhat / (torch.sqrt(vhat) + eps)
    return table + torch.where(hit, update, 0.0), SparseAdamState(m, v, t)
