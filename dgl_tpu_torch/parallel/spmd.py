"""Data-parallel training steps over a :class:`~.mesh.Mesh` (counterpart of
``dgl_tpu/parallel/spmd.py``; reference torch-DDP gradient plane,
``examples/distributed/graphsage/node_classification.py:346``, and the
sharded ``DistEmbedding``, ``distributed/nn/pytorch/sparse_emb.py:9``).

In PyTorch's idiom: a module, a loss over a batch and a ``torch.optim``
optimizer. A batch's leading axis is sharded over ``dp``; the step averages
gradients over ``dp``. On the one-process mesh the whole batch is here and
the loss's own mean over it is that average (the JAX package's ``vmap``
and mean); across processes each rank's gradients are ``all_reduce``d and
divided by the axis size. On the one-process mesh ``param_shardings``
keeps each tensor whole on the mesh's device: a ``tp`` spec records where
rows would live, and never changes the numbers.
"""
from __future__ import annotations

import re
from typing import Callable, Dict

import numpy as np
import torch

from .mesh import AXES, Mesh

__all__ = ["PartitionSpec", "shard_batch", "replicate", "param_shardings",
           "sharded_train_step"]


class PartitionSpec(tuple):
    """Axis name (or None) per tensor dimension, as ``jax.sharding.
    PartitionSpec``: ``PartitionSpec("tp", None)`` shards rows over
    ``tp``."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)


def _is_graph(x) -> bool:
    from ..graph import Graph

    return isinstance(x, Graph)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return type(tree)((k, _tree_map(fn, v)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)) and not (
            tree and all(_is_graph(t) for t in tree)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _rows(mesh: Mesh, axis: str, n: int):
    """This process's slice of ``n`` rows sharded over ``axis``, or None
    when they stay whole (one-process mesh, or not divisible)."""
    size = mesh.shape[axis]
    if mesh.one_process or n % size:
        return None
    per = n // size
    c = mesh.coord(axis)
    return slice(c * per, (c + 1) * per)


def shard_batch(mesh: Mesh, tree, axis: str = "dp"):
    """Put a batch on the mesh, sharding each leaf's leading dimension
    over ``axis``: tensors and arrays move to the mesh's device, and
    across processes each rank keeps its rows; a list of graphs is a batch
    of graphs. 0-d leaves and leading dimensions the axis does not divide
    stay whole (replicated), as in the reference."""

    def put(x):
        if isinstance(x, (list, tuple)) and x and all(_is_graph(t)
                                                      for t in x):
            sl = _rows(mesh, axis, len(x))
            return [g.to(mesh.device) for g in (x[sl] if sl else x)]
        if _is_graph(x):
            return x.to(mesh.device)
        if isinstance(x, np.ndarray) or np.isscalar(x):
            x = torch.as_tensor(np.asarray(x))
        if not isinstance(x, torch.Tensor):
            return x
        x = x.to(mesh.device)
        sl = _rows(mesh, axis, x.shape[0]) if x.dim() else None
        return x[sl] if sl else x

    return _tree_map(put, tree)


def replicate(mesh: Mesh, tree):
    """Every leaf whole on the mesh's device (graphs too)."""

    def put(x):
        if isinstance(x, (list, tuple)):
            return [g.to(mesh.device) for g in x]
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.ascontiguousarray(x))
        return x.to(mesh.device) if hasattr(x, "to") else x

    return _tree_map(put, tree)


def param_shardings(mesh: Mesh, params, rules: Dict[str, tuple]):
    """Map parameter-name regexes to :class:`PartitionSpec`; unmatched
    parameters replicate. ``params`` is a module or a dict of tensors;
    returned on the mesh's device, whole. The specs each name took are
    kept in ``mesh.param_specs``."""
    named = (dict(params.named_parameters())
             if isinstance(params, torch.nn.Module) else dict(params))
    specs = {}
    for name in named:
        key = name.replace(".", "/")
        specs[name] = next((PartitionSpec(*s) for pat, s in rules.items()
                            if re.search(pat, key)), PartitionSpec())
    mesh.param_specs = specs
    if isinstance(params, torch.nn.Module):
        return params.to(mesh.device)
    return {k: v.to(mesh.device) for k, v in params.items()}


def sharded_train_step(mesh: Mesh, loss_fn: Callable, optimizer) -> Callable:
    """A data-parallel training step over ``mesh``.

    ``loss_fn(model, batch) -> scalar``. The returned ``step(model,
    batch) -> loss`` runs the forward and backward, averages every
    gradient over ``dp`` across processes (the one-process mesh holds the
    whole batch), and steps ``optimizer``. The loss returned is the mean
    over ``dp``. PyTorch updates in place, so the reference's ``donate``
    has no counterpart."""
    axis = AXES.dp

    def step(model, batch):
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(model, batch)
        loss.backward()
        mesh.sum_grads([p for pg in optimizer.param_groups
                        for p in pg["params"]], axis, mean=True)
        size = mesh.shape[axis]
        if not mesh.one_process and size > 1:
            import torch.distributed as dist

            loss = loss.detach().clone()
            dist.all_reduce(loss, group=mesh._groups[axis])
            loss = loss / size
        optimizer.step()
        return loss.detach()

    return step
