"""Grouped reversible residual connections (counterpart of
``dgl_tpu/nn/conv/grouprevres.py``; reference
``python/dgl/nn/pytorch/conv/grouprevres.py``, RevGNN).

Split ``x`` into G groups along the last dim; ``y = sum(xs[1:])``; for
each group ``i``: ``y = xs[i] + f_i(g, y)``; the result is the groups'
``y`` concatenated. The reference trades memory for FLOPs with
``jax.checkpoint``; the port's ``remat`` runs each group under
``torch.utils.checkpoint`` (non-reentrant), which keeps only the group's
inputs and recomputes the rest in the backward, replaying the random
state so that dropout draws the same mask.
"""
from __future__ import annotations

from typing import Callable, Union

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

__all__ = ["GroupRevRes", "InvertibleCheckpoint"]


class GroupRevRes(nn.Module):
    """(reference ``grouprevres.py:101``).

    ``gnn_module``: an ``nn.Module`` shared by every group, or a factory
    ``i -> nn.Module`` (one module a group, as the reference's deep
    copies). The groups' modules are ``gnns.<i>`` (flax names them by
    class, e.g. ``GraphConv_<i>``, or ``rev<i>`` with ``remat``).
    ``forward(g, x, *args)`` splits ``x`` and each of ``args`` into the
    groups along the last dim."""

    def __init__(self, gnn_module: Union[nn.Module, Callable[[int],
                                                             nn.Module]],
                 groups: int = 2, remat: bool = False):
        super().__init__()
        self.groups, self.remat = groups, remat
        if isinstance(gnn_module, nn.Module):
            mods = [gnn_module] * groups
        else:
            mods = [gnn_module(i) for i in range(groups)]
        self.gnns = nn.ModuleList(mods)

    def forward(self, g, x, *args):
        xs = torch.chunk(x, self.groups, dim=-1)
        chunks = ([()] * self.groups if not args else list(zip(
            *(torch.chunk(a, self.groups, dim=-1) for a in args))))
        y_in = sum(xs[1:])
        ys = []
        for i, f in enumerate(self.gnns):
            if self.remat and torch.is_grad_enabled():
                y_new = checkpoint(f, g, y_in, *chunks[i],
                                   use_reentrant=False,
                                   preserve_rng_state=True)
            else:
                y_new = f(g, y_in, *chunks[i])
            y_in = xs[i] + y_new
            ys.append(y_in)
        return torch.cat(ys, -1)


def InvertibleCheckpoint(fn):
    """Rematerialisation wrapper (reference ``grouprevres.py:10``): ``fn``
    run under ``torch.utils.checkpoint``, which recomputes its
    intermediates in the backward (the random state replayed)."""
    def run(*args):
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=True)
    return run
