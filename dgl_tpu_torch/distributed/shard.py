"""Fixed-shape graph shards with halo routing tables (counterpart of
``dgl_tpu/distributed/shard.py``; reference per-partition DGLGraph and
remote feature pulls, ``dist_graph.py:648``, ``kvstore.py:1445``).

Every part gets identical static shapes (node cap, edge cap, halo cap), and
the halo routing of each (source part, destination part) pair is an index
table read by one ``all_to_all``. The build is vectorised integer ``torch``
on the graph's device: the halo rows of every pair and each remote edge's
slot come from one ``torch.unique`` of (pair, row) keys (the reference
looks each remote edge up in a dict). The arrays are the reference's,
exactly.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..graph import Graph, _asnumpy

__all__ = ["GraphShards", "build_shards"]


def _rup(x: int, m: int) -> int:
    return int(-(-int(x) // m) * m)


def _ids(a, device) -> torch.Tensor:
    """An int64 id array or tensor on ``device``."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=torch.int64)
    return torch.from_numpy(np.asarray(a, np.int64)).to(device)


def _stable_argsort(keys: torch.Tensor) -> torch.Tensor:
    return torch.sort(keys, stable=True).indices


def _part_major(parts: torch.Tensor, num_parts: int):
    """The part-major relabelling: (order new -> old, new_of_old, counts,
    ranges, part of each new id)."""
    n = parts.shape[0]
    order = _stable_argsort(parts)
    new_of_old = torch.empty_like(order)
    new_of_old[order] = torch.arange(n, device=parts.device)
    counts = torch.bincount(parts, minlength=num_parts)
    ranges = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])
    part_of_new = torch.repeat_interleave(
        torch.arange(num_parts, device=parts.device), counts)
    return order, new_of_old, counts, ranges, part_of_new


def _halo_slots(q, p, rows, num_parts: int, n_src: int):
    """The halo rows of every (q -> p) pair, sorted, and each remote
    reference's slot among its pair's rows: ``(pair of each row, row,
    slot of each row within its pair, count a pair, slot of each
    reference)``. One ``torch.unique`` of (pair, row) keys."""
    pair = q * num_parts + p
    n_src = max(n_src, 1)
    uk, inv = torch.unique(pair * n_src + rows, sorted=True,
                           return_inverse=True)
    upair, urow = uk // n_src, uk % n_src
    pcount = torch.bincount(upair, minlength=num_parts * num_parts)
    pstart = torch.cumsum(pcount, 0) - pcount
    uslot = torch.arange(uk.shape[0], device=uk.device) - pstart[upair]
    return upair, urow, uslot, pcount, inv - pstart[pair]


def _send_tables(upair, urow, uslot, num_parts: int, h_max: int):
    send_idx = torch.zeros((num_parts, num_parts, h_max), dtype=torch.int32,
                           device=upair.device)
    send_mask = torch.zeros((num_parts, num_parts, h_max), dtype=torch.bool,
                            device=upair.device)
    at = (upair // num_parts, upair % num_parts, uslot)
    send_idx[at] = urow.to(torch.int32)
    send_mask[at] = True
    return send_idx, send_mask


def _max(t: torch.Tensor) -> int:
    return int(t.max()) if t.numel() else 0


@dataclass
class GraphShards:
    """Static-shape shards of one homogeneous graph.

    Node ids are relabelled part-major (part p owns global [ranges[p],
    ranges[p+1])); each part's local ids are 0..n_owned[p]-1. Edge arrays
    are grouped by local destination per part, in the *extended* feature
    space: index < n_max is a local row, n_max + q*h_max + j is halo slot
    j received from part q. The tables are tensors on the build's device.
    """

    num_parts: int
    n_max: int           # node cap per part
    e_max: int           # edge cap per part
    h_max: int           # halo rows cap per (src_part, dst_part) pair
    n_owned: np.ndarray  # (P,)
    ranges: np.ndarray   # (P+1,) global id ranges
    order: np.ndarray    # (N,) new-id -> old-id permutation
    new_of_old: np.ndarray  # (N,) old-id -> new-id
    src_ext: torch.Tensor    # (P, e_max) int32 into extended space
    dst_local: torch.Tensor  # (P, e_max) int32, n_max = padding
    edge_mask: torch.Tensor  # (P, e_max) bool
    send_idx: torch.Tensor   # (P, P, h_max) int32 local rows to send
    send_mask: torch.Tensor  # (P, P, h_max) bool
    in_deg: torch.Tensor     # (P, n_max) float32 true in-degrees
    eids_tbl: np.ndarray = None  # (P, e_max) original edge ids (the port's)

    def _slots(self) -> np.ndarray:
        """Flat (P * n_max) slot of each new id."""
        new = np.arange(self.order.shape[0])
        part = np.repeat(np.arange(self.num_parts), self.n_owned)
        return part * self.n_max + new - self.ranges[part]

    def shard_features(self, x_global) -> torch.Tensor:
        """(N, F) global features (old ids) -> (P, n_max, F) padded,
        part-major, on the tables' device."""
        x = torch.as_tensor(x_global).to(self.src_ext.device)
        out = x.new_zeros((self.num_parts * self.n_max,) + x.shape[1:])
        slots = torch.from_numpy(self._slots()).to(x.device)
        out[slots] = x[torch.from_numpy(self.order).to(x.device)]
        return out.reshape((self.num_parts, self.n_max) + x.shape[1:])

    def shard_edge_data(self, w) -> torch.Tensor:
        """Per-edge values ``w`` (E, [F]) in the (P, e_max[, F]) layout of
        ``src_ext``/``dst_local`` (the edge values ``dist_spmm`` takes);
        padding slots get zeros."""
        w = torch.as_tensor(w).to(self.src_ext.device)
        tbl = torch.from_numpy(self.eids_tbl).to(w.device)
        m = self.edge_mask.reshape(self.edge_mask.shape + (1,) * (
            w.dim() - 1)).to(w.dtype)
        return w[tbl] * m

    def unshard(self, x_sharded) -> torch.Tensor:
        """(P, n_max, F) -> (N, F) in OLD id order."""
        x = torch.as_tensor(x_sharded)
        flat = x.reshape((-1,) + x.shape[2:])
        slots = torch.from_numpy(self._slots()).to(x.device)
        out = x.new_zeros((self.order.shape[0],) + x.shape[2:])
        out[torch.from_numpy(self.order).to(x.device)] = flat[slots]
        return out


def build_shards(g: Graph, parts, num_parts: int, *,
                 pad_multiple: int = 8) -> GraphShards:
    """Partition assignment -> static shards + halo routing (one time,
    integer ``torch`` ops on the graph's device, where the tables stay)."""
    device = g.device
    rel = g._relation(None)
    n = g.num_nodes()
    E = rel.num_edges
    src = rel.src[:E].to(device=device, dtype=torch.int64)
    dst = rel.dst[:E].to(device=device, dtype=torch.int64)
    P = int(num_parts)
    order, new_of_old, counts, ranges, part_of_new = _part_major(
        _ids(_asnumpy(parts), device), P)
    n_max = _rup(_max(counts), pad_multiple)

    src_new, dst_new = new_of_old[src], new_of_old[dst]
    del src, dst
    src_part, dst_part = part_of_new[src_new], part_of_new[dst_new]
    src_local = src_new - ranges[src_part]
    dst_local_all = dst_new - ranges[dst_part]

    # halo rows per (q -> p), and each remote edge's slot
    rem = src_part != dst_part
    upair, urow, uslot, pcount, slot = _halo_slots(
        src_part[rem], dst_part[rem], src_local[rem], P, n)
    h_max = max(_rup(_max(pcount), pad_multiple), pad_multiple)
    send_idx, send_mask = _send_tables(upair, urow, uslot, P, h_max)

    e_counts = torch.bincount(dst_part, minlength=P)
    e_max = max(_rup(_max(e_counts), pad_multiple), pad_multiple)
    ext = src_local.clone()
    ext[rem] = n_max + src_part[rem] * h_max + slot

    # edges by (part, local dst), stably: a stable sort of the new dst ids
    sel = _stable_argsort(dst_new)
    ep = dst_part[sel]
    k = torch.arange(E, device=device) - (torch.cumsum(e_counts, 0)
                                          - e_counts)[ep]
    src_ext = torch.zeros((P, e_max), dtype=torch.int32, device=device)
    dst_loc = torch.full((P, e_max), n_max, dtype=torch.int32, device=device)
    emask = torch.zeros((P, e_max), dtype=torch.bool, device=device)
    eids = torch.zeros((P, e_max), dtype=torch.int64, device=device)
    src_ext[ep, k] = ext[sel].to(torch.int32)
    dst_loc[ep, k] = dst_local_all[sel].to(torch.int32)
    emask[ep, k] = True
    eids[ep, k] = sel
    in_deg = torch.bincount(dst_part * n_max + dst_local_all,
                            minlength=P * n_max).to(torch.float32)

    return GraphShards(
        num_parts=P, n_max=n_max, e_max=e_max, h_max=h_max,
        n_owned=counts.cpu().numpy(), ranges=ranges.cpu().numpy(),
        order=order.cpu().numpy(), new_of_old=new_of_old.cpu().numpy(),
        src_ext=src_ext, dst_local=dst_loc, edge_mask=emask,
        send_idx=send_idx, send_mask=send_mask,
        in_deg=in_deg.reshape(P, n_max), eids_tbl=eids.cpu().numpy(),
    )
