"""On-device neighbour sampling (counterpart of
``dgl_tpu/sampling/device_sampler.py:51-185``).

The graph's CSC (int32) stays on the card and a neighbour pick is a
gather, so seeds, frontier expansion, feature gather and the training step
all run on the device and the message-flow graph never exists on the host.

Semantics (reference ``sample_neighbors``,
``src/graph/sampling/neighbor/neighbor.cc:279``):

- in-degree ``d <= fanout``: take all in-neighbours, in CSC order (slots
  ``j < d`` real, the rest masked);
- ``d > fanout``: ``fanout`` uniform picks. ``mode="replace"`` draws with
  replacement; ``mode="unique"`` (the default) also masks a pick equal to
  an earlier one; ``mode="exact"`` draws without replacement, pick ``t``
  being the ``r_t``-th smallest offset not yet picked.

A level draws ``u = torch.rand((num, fanout))`` from the caller's
``torch.Generator`` and hands it to :func:`_pick`, which does the
reference's arithmetic on it (f32 products truncated to int32), so the
same draws give the reference's picks. Frontiers are not deduplicated.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import torch

__all__ = ["DeviceMFG", "DeviceNeighborSampler", "device_seed_batches"]


class DeviceMFG(NamedTuple):
    """Fixed-shape on-device message-flow graph.

    ``frontiers[0]`` are the seeds (outermost layer);
    ``frontiers[l + 1] = cat([frontiers[l], nbrs[l].reshape(-1)])``, so the
    first ``len(frontiers[l])`` entries of every frontier are the previous
    frontier. ``nbrs[l]``: (num_l, fanout_l) int32 in-neighbour ids;
    ``masks[l]``: their validity (False: padding, a masked duplicate or a
    masked seed's subtree); ``seed_mask``: (batch,) validity of the seeds.
    """

    frontiers: List[torch.Tensor]
    nbrs: List[torch.Tensor]
    masks: List[torch.Tensor]
    seed_mask: torch.Tensor

    @property
    def num_layers(self) -> int:
        return len(self.nbrs)

    def num_real_edges(self) -> torch.Tensor:
        """Unmasked message edges over all layers, a 0-d tensor on the
        device (read it when the host needs it)."""
        return sum(m.sum() for m in self.masks)

    def input_nodes(self) -> torch.Tensor:
        """Ids whose features the model consumes (innermost frontier)."""
        return self.frontiers[-1]


def _pick(u, start, deg, fanout: int, mode: str):
    """The picks of one level from its draws ``u`` (num, fanout) in
    [0, 1): the CSC positions (int32) and their mask. ``start`` and
    ``deg`` are each frontier node's in-edge offset and in-degree
    (int32)."""
    deg_c = deg[:, None]
    off_rand = torch.minimum((u * deg_c).to(torch.int32),
                             torch.clamp(deg_c - 1, min=0))
    j = torch.arange(fanout, dtype=torch.int32, device=u.device)[None, :]
    take_all = deg_c <= fanout
    off = torch.where(take_all, j, off_rand)
    mask = torch.where(take_all, j < deg_c, deg_c > 0)
    if mode == "unique":
        # a pick equal to an earlier slot's is masked; take-all rows have
        # distinct offsets already
        earlier = torch.ones(fanout, fanout, dtype=torch.bool,
                             device=u.device).tril(-1)
        dup = (off[:, :, None] == off[:, None, :]) & earlier
        mask = mask & ~dup.any(2)
    elif mode == "exact":
        # pick t is the r_t-th smallest unused offset, r_t ~ U[0, d - t):
        # bump r_t past the earlier picks (a monotone fixpoint that t
        # steps reach)
        cols = []
        for t in range(fanout):
            span = torch.clamp(deg - t, min=1).to(torch.float32)
            r = torch.minimum((u[:, t] * span).to(torch.int32),
                              torch.clamp(deg - t - 1, min=0))
            adj = r
            for _ in range(t):
                prev = torch.stack(cols, 1)
                adj = r + (prev <= adj[:, None]).sum(1).to(r.dtype)
            cols.append(adj)
        off = torch.where(take_all, j, torch.stack(cols, 1))
    return start[:, None] + off, mask


def _sample_level(gen, indptr, indices, frontier, fanout: int, mode: str):
    """One frontier expansion: ``fanout`` in-neighbour picks per node."""
    start = indptr.index_select(0, frontier)
    deg = indptr.index_select(0, frontier + 1) - start
    u = torch.rand((frontier.shape[0], fanout), generator=gen,
                   device=indptr.device)
    pos, mask = _pick(u, start, deg, fanout, mode)
    # a masked pick of a node without in-edges points at its offset,
    # which may be the end of the array: read inside it, as a clamped
    # gather does
    pos = torch.clamp(pos, max=max(indices.shape[0] - 1, 0))
    nbr = indices.index_select(0, pos.reshape(-1))
    return nbr.reshape(pos.shape), mask


class DeviceNeighborSampler:
    """Fixed-shape multi-layer neighbour sampler that runs on the device.

    ``fanouts[0]`` is the innermost (input-side) layer, as in the
    reference. :meth:`sample` takes the CSC (``indptr``, ``indices``,
    int32, on the device) and a ``torch.Generator`` on the same device.
    """

    def __init__(self, fanouts: Sequence[int], mode: str = "unique"):
        if mode not in ("unique", "replace", "exact"):
            raise ValueError(
                f"mode must be 'unique', 'replace' or 'exact', got {mode!r}")
        self.fanouts = list(fanouts)
        self.mode = mode

    def sample(self, gen: torch.Generator, indptr, indices, seeds,
               seed_mask: Optional[torch.Tensor] = None) -> DeviceMFG:
        """One draw of ``torch.rand`` a layer, outermost layer first."""
        seeds = seeds.to(torch.int32)
        if seed_mask is None:
            seed_mask = torch.ones(seeds.shape, dtype=torch.bool,
                                   device=seeds.device)
        frontiers, nbrs, masks = [seeds], [], []
        cur, cur_mask = seeds, seed_mask
        for fanout in reversed(self.fanouts):
            nbr, mask = _sample_level(gen, indptr, indices, cur, fanout,
                                      self.mode)
            mask = mask & cur_mask[:, None]
            nbrs.append(nbr)
            masks.append(mask)
            cur = torch.cat([cur, nbr.reshape(-1)])
            cur_mask = torch.cat([cur_mask, mask.reshape(-1)])
            frontiers.append(cur)
        return DeviceMFG(frontiers, nbrs, masks, seed_mask)

    def sample_from(self, gen: torch.Generator, g, seeds,
                    **kw) -> DeviceMFG:
        """:meth:`sample` over a graph's one relation (its CSC as int32),
        which may join two node types; a graph of several edge types
        raises ``DGLError``, as the reference does."""
        rel = g._relation(None)
        return self.sample(gen, rel.csc_indptr.to(torch.int32),
                           rel.csc_indices.to(torch.int32), seeds, **kw)


def _same_device(a: torch.device, b: torch.device) -> bool:
    return a.type == b.type and (a.index is None or b.index is None
                                 or a.index == b.index)


def device_seed_batches(gen: torch.Generator, num_nodes: int,
                        batch_size: int,
                        train_mask: Optional[torch.Tensor] = None,
                        device="cuda"):
    """An epoch's seed schedule on the device: a shuffled
    (num_batches, batch_size) int64 id array and its validity mask, the
    last batch padded with masked id 0.

    With ``train_mask``, ids outside it are masked: the schedule still
    covers all ``num_nodes`` slots, so its shape is the same every epoch.
    ``gen`` must be a generator of ``device``.
    """
    device = torch.device(device)
    if not _same_device(gen.device, device):
        raise ValueError(f"the generator is on {gen.device}, the schedule "
                         f"goes to {device}: give a generator of {device}")
    perm = torch.randperm(num_nodes, generator=gen, device=device)
    nb = -(-num_nodes // batch_size)
    pad = nb * batch_size - num_nodes
    ids = torch.cat([perm, perm.new_zeros(pad)])
    mask = torch.arange(nb * batch_size, device=device) < num_nodes
    if train_mask is not None:
        mask = mask & train_mask.to(torch.bool).index_select(0, ids)
    return ids.reshape(nb, batch_size), mask.reshape(nb, batch_size)
