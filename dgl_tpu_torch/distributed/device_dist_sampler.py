"""On-device distributed neighbour sampling (counterpart of
``dgl_tpu/distributed/device_dist_sampler.py``): the device sampler of
``sampling/device_sampler.py`` across a mesh of parts.

Each part holds its CSC on the device (destination-owner partitioning,
the :class:`PartitionedGraphCSC` layout), and a layer expansion is

1. group the frontier by owner part (one ``searchsorted`` on the ranges),
2. ship ids to their owners with ONE masked ``all_to_all`` (the
   on-device analogue of ``_distributed_access``'s per-partition
   requests, ``graph_services.py:737``),
3. every owner answers all requests from its local CSC with the single
   sampler's fixed-shape picks,
4. ship the picks back with the reverse ``all_to_all``, the validity in
   the id's sign (-1 on a masked pick), and select each requester's answer.

Everything is fixed-shape. Each part draws from a ``torch.Generator`` of
its own (the reference gives each rank a JAX key), so one part's picks are
the same whether one process holds every part or each holds one; they
differ from the reference's draws, and the picks' rules are the same.
:meth:`DeviceDistSampler.comm_bytes_per_sample` gives the analytic
exchange bytes a part, which the mesh's counted bytes are held against.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..sampling.device_sampler import DeviceMFG, _pick

__all__ = ["DeviceDistSampler", "shard_csc_arrays"]


def shard_csc_arrays(pg, device="cuda"):
    """Pad a :class:`PartitionedGraphCSC` into stackable shards:
    ``(indptr (P, n_max+1), indices (P, e_max))`` int32 on ``device``,
    each part's CSC with GLOBAL (part-major) source ids; padding rows have
    degree 0."""
    P = pg.num_parts
    n_max = pg.n_max
    e_max = max(max(ix.shape[0] for ix in pg.indices), 1)
    indptr = np.zeros((P, n_max + 1), np.int32)
    indices = np.zeros((P, e_max), np.int32)
    for p in range(P):
        ip = pg.indptr[p]
        indptr[p, : ip.shape[0]] = ip
        indptr[p, ip.shape[0]:] = ip[-1]  # padding rows: degree 0
        indices[p, : pg.indices[p].shape[0]] = pg.indices[p]
    return (torch.from_numpy(indptr).to(device),
            torch.from_numpy(indices).to(device))


class DeviceDistSampler:
    """Fixed-shape multi-layer sampler over owner-sharded CSC, run over a
    mesh's leading part axis.

    ``ranges``: (P+1,) part-major ownership ranges. ``fanouts`` follow the
    reference convention (``fanouts[0]`` innermost).
    """

    def __init__(self, fanouts: Sequence[int], ranges, mode: str = "unique"):
        self.fanouts = list(fanouts)
        self.ranges = np.asarray(ranges)
        self.mode = mode

    # -- comm accounting ----------------------------------------------------

    def comm_bytes_per_layer(self, frontier_size: int, num_parts: int,
                             fanout: int, id_bytes: int = 4):
        """Analytic all-to-all bytes of one layer expansion for one part:
        requests (P, m) ids + responses (P, m, fanout) ids (the validity
        rides in the id's sign)."""
        m = frontier_size
        return num_parts * m * id_bytes + num_parts * m * fanout * id_bytes

    def comm_bytes_per_sample(self, batch_size: int, num_parts: int,
                              id_bytes: int = 4):
        total, m = 0, batch_size
        for fanout in reversed(self.fanouts):
            total += self.comm_bytes_per_layer(m, num_parts, fanout,
                                               id_bytes)
            m = m + m * fanout
        return total

    # -- the expansion ------------------------------------------------------

    def sample_shard(self, mesh, gens, indptr_loc, indices_loc, seeds,
                     axis: str = "gp",
                     seed_mask: Optional[torch.Tensor] = None) -> DeviceMFG:
        """Sample the MFGs of the parts held here for their ``seeds``
        (L, B) global ids. ``gens``: one ``torch.Generator`` of the mesh's
        device a part (all P, or the L held here). ``indptr_loc``/
        ``indices_loc``: the CSC shards (``shard_csc_arrays``; all P rows
        are cut to the parts held here). The MFG's tensors carry the part
        axis in front."""
        P = mesh.shape[axis]
        gens = list(gens)
        if len(gens) == P and mesh.parts(axis) != P:
            gens = gens[mesh.coord(axis):mesh.coord(axis) + 1]
        ranges = torch.as_tensor(self.ranges.astype(np.int64),
                                 device=mesh.device)
        me = mesh.axis_index(axis)
        indptr = mesh.local(indptr_loc, axis)
        indices = mesh.local(indices_loc, axis)
        seeds = mesh.local(seeds, axis).to(torch.int32).contiguous()
        L, rows = indptr.shape[0], indptr.shape[1] - 1
        if len(gens) != L:
            raise ValueError(f"{len(gens)} generators for {L} parts")
        e_max = indices.shape[1]
        # the parts' CSCs as one: part l's rows and edges shifted by l
        flat_ptr = (indptr.long() + torch.arange(
            L, device=indptr.device)[:, None] * e_max).reshape(-1)
        flat_idx = indices.reshape(-1)
        row0 = torch.arange(L, device=indptr.device)[:, None] * (rows + 1)
        if seed_mask is None:
            seed_mask = torch.ones(seeds.shape, dtype=torch.bool,
                                   device=seeds.device)
        else:
            seed_mask = mesh.local(seed_mask, axis)
        parts = torch.arange(P, device=seeds.device)
        frontiers, nbrs, masks = [seeds], [], []
        cur, cur_mask = seeds, seed_mask
        for fanout in reversed(self.fanouts):
            m = cur.shape[1]
            owner = torch.clamp(torch.searchsorted(
                ranges, cur.long(), right=True) - 1, 0, P - 1)   # (L, m)
            onehot = owner[:, None, :] == parts[None, :, None]  # (L, P, m)
            req = torch.where(onehot & cur_mask[:, None, :],
                              cur[:, None, :], -1).to(torch.int32)
            req_t = mesh.all_to_all(req, axis).reshape(L, P * m)
            valid = req_t >= 0
            local = torch.clamp(req_t.long() - ranges[me][:, None], 0,
                                rows - 1)
            # the requests' picks from the local CSCs (invalid requests
            # read row 0 and are masked)
            frontier = (torch.where(valid, local, 0) + row0).reshape(-1)
            start = flat_ptr.index_select(0, frontier)
            deg = flat_ptr.index_select(0, frontier + 1) - start
            u = torch.cat([torch.rand((P * m, fanout), generator=g,
                                      device=mesh.device) for g in gens])
            pos, mask_f = _pick(u, start, deg, fanout, self.mode)
            pos = torch.clamp(pos, max=max(flat_idx.shape[0] - 1, 0))
            nbr_f = flat_idx.index_select(0, pos.reshape(-1)).reshape(
                pos.shape)
            mask_f = mask_f & valid.reshape(-1, 1)
            # the validity rides in the id's sign
            nbr_t = torch.where(mask_f, nbr_f, -1).to(torch.int32).reshape(
                L, P, m, fanout)
            resp = mesh.all_to_all(nbr_t, axis)
            # each frontier id was served by exactly its owner
            nbr = torch.gather(resp, 1, owner[:, None, :, None].expand(
                L, 1, m, fanout))[:, 0]
            mask = (nbr >= 0) & cur_mask[..., None]
            nbrs.append(nbr)
            masks.append(mask)
            cur = torch.cat([cur, nbr.reshape(L, -1)], dim=1)
            cur_mask = torch.cat([cur_mask, mask.reshape(L, -1)], dim=1)
            frontiers.append(cur)
        return DeviceMFG(frontiers, nbrs, masks, seed_mask)
