"""Heterogeneous fixed-shape shards and halo-exchange message passing
(counterpart of ``dgl_tpu/distributed/hetero_shard.py``).

Per node type a part-major relabelling and halo routing tables; per
canonical edge type edge tables in the extended (local + halo) source
space. A step runs one ``all_to_all`` per source node type, then a local
reduction per edge type, summed per destination type (the R-GCN /
papers100M distributed configuration). The build is vectorised integer
``torch`` as ``shard.py``'s is (the reference collects each remote edge
into a Python set and looks it up in a dict); the arrays are the
reference's.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch

from ..graph import Graph, _asnumpy
from .dist_spmm import _rows_of, _segment
from .shard import (_halo_slots, _ids, _max, _part_major, _rup,
                    _send_tables, _stable_argsort)

__all__ = [
    "HeteroGraphShards",
    "build_hetero_shards",
    "dist_hetero_copy_u_sum",
    "init_hetero_halo_state",
    "dist_hetero_copy_u_sum_delayed",
]


@dataclass
class HeteroGraphShards:
    num_parts: int
    ntypes: tuple
    cetypes: tuple
    n_max: Dict[str, int]
    h_max: Dict[str, int]
    e_max: Dict[tuple, int]
    ranges: Dict[str, np.ndarray]
    order: Dict[str, np.ndarray]        # new->old per ntype
    new_of_old: Dict[str, np.ndarray]
    send_idx: Dict[str, torch.Tensor]   # per src ntype (P, P, h_max)
    send_mask: Dict[str, torch.Tensor]
    src_ext: Dict[tuple, torch.Tensor]  # per cetype (P, e_max)
    dst_local: Dict[tuple, torch.Tensor]
    in_deg: Dict[str, torch.Tensor]     # per dst ntype (P, n_max), all etypes
    eids_tbl: Dict[tuple, np.ndarray]   # per cetype (P, e_max) original eids
    e_mask: Dict[tuple, np.ndarray]     # per cetype (P, e_max) real edges

    def _slots(self, nt) -> np.ndarray:
        r = self.ranges[nt]
        counts = np.diff(r)
        part = np.repeat(np.arange(self.num_parts), counts)
        new = np.arange(r[-1])
        return part * self.n_max[nt] + new - r[part]

    def _device(self):
        return next(iter(self.in_deg.values())).device

    def shard_features(self, feats: Dict[str, object]):
        """{ntype: (N, F) old ids} -> {ntype: (P, n_max, F)} part-major."""
        out = {}
        dev = self._device()
        for nt, x in feats.items():
            x = torch.as_tensor(x).to(dev)
            buf = x.new_zeros((self.num_parts * self.n_max[nt],)
                              + x.shape[1:])
            buf[torch.from_numpy(self._slots(nt)).to(dev)] = x[
                torch.from_numpy(self.order[nt]).to(dev)]
            out[nt] = buf.reshape((self.num_parts, self.n_max[nt])
                                  + x.shape[1:])
        return out

    def unshard(self, sharded: Dict[str, torch.Tensor]):
        out = {}
        for nt, x in sharded.items():
            x = torch.as_tensor(x)
            flat = x.reshape((-1,) + x.shape[2:])
            buf = x.new_zeros((int(self.ranges[nt][-1]),) + x.shape[2:])
            buf[torch.from_numpy(self.order[nt]).to(x.device)] = flat[
                torch.from_numpy(self._slots(nt)).to(x.device)]
            out[nt] = buf
        return out

    def shard_edge_data(self, cet, w):
        """Per-edge values ``w`` (E, [F]) of ``cet`` in the (P, e_max[, F])
        layout of ``src_ext``/``dst_local``; padding slots get zeros
        (reference DistGraph edata access)."""
        dev = self._device()
        w = torch.as_tensor(w).to(dev)
        tbl = torch.from_numpy(self.eids_tbl[cet]).to(dev)
        m = torch.from_numpy(self.e_mask[cet]).to(dev)
        return w[tbl] * m.reshape(m.shape + (1,) * (w.dim() - 1)).to(
            w.dtype)


def build_hetero_shards(g: Graph, assign: Dict[str, np.ndarray],
                        num_parts: int,
                        pad_multiple: int = 8) -> HeteroGraphShards:
    """Per-type assignments -> static shards + halo routing (integer
    ``torch`` on the graph's device, where the tables stay)."""
    device = g.device
    P = int(num_parts)

    def rup(x):
        return max(_rup(x, pad_multiple), pad_multiple)

    ntypes = tuple(g.ntypes)
    cetypes = tuple(g.canonical_etypes)
    order, new_of_old, ranges, n_max, part_of = {}, {}, {}, {}, {}
    for nt in ntypes:
        o, noo, counts, r, pon = _part_major(
            _ids(_asnumpy(assign[nt]), device), P)
        order[nt], new_of_old[nt], ranges[nt], part_of[nt] = o, noo, r, pon
        n_max[nt] = rup(_max(counts))

    edge_info = {}
    remote = {nt: [] for nt in ntypes}
    for cet in cetypes:
        st, _, dt_ = cet
        rel = g._relations[cet]
        E = rel.num_edges
        src_new = new_of_old[st][rel.src[:E].to(device, torch.int64)]
        dst_new = new_of_old[dt_][rel.dst[:E].to(device, torch.int64)]
        sp_, dp_ = part_of[st][src_new], part_of[dt_][dst_new]
        sl = src_new - ranges[st][sp_]
        dl = dst_new - ranges[dt_][dp_]
        rem = sp_ != dp_
        edge_info[cet] = (sp_, sl, dp_, dl, dst_new, rem)
        remote[st].append(cet)

    # the halo rows of a source type: the union over its edge types, and
    # each remote edge's slot
    h_max, slots, send_idx, send_mask = {}, {}, {}, {}
    for nt in ntypes:
        infos = [edge_info[cet] for cet in remote[nt]]
        cat = [torch.cat([i[k][i[5]] for i in infos])
               if infos else torch.zeros(0, dtype=torch.int64, device=device)
               for k in (0, 2, 1)]
        upair, urow, uslot, pcount, slot = _halo_slots(
            *cat, P, int(ranges[nt][-1]))
        h_max[nt] = rup(_max(pcount))
        send_idx[nt], send_mask[nt] = _send_tables(upair, urow, uslot, P,
                                                   h_max[nt])
        sizes = [int(i[5].sum()) for i in infos]
        slots.update(zip(remote[nt], torch.split(slot, sizes)))

    src_ext, dst_local, e_max, eids_tbl, e_mask = {}, {}, {}, {}, {}
    in_deg = {nt: torch.zeros(P * n_max[nt], dtype=torch.float32,
                              device=device) for nt in ntypes}
    for cet in cetypes:
        st, _, dt_ = cet
        sp_, sl, dp_, dl, dst_new, rem = edge_info[cet]
        E = sp_.shape[0]
        counts = torch.bincount(dp_, minlength=P)
        em = rup(_max(counts))
        e_max[cet] = em
        ext = sl.clone()
        ext[rem] = n_max[st] + sp_[rem] * h_max[st] + slots[cet]
        sel = _stable_argsort(dst_new)
        ep = dp_[sel]
        k = torch.arange(E, device=device) - (torch.cumsum(counts, 0)
                                              - counts)[ep]
        se = torch.zeros((P, em), dtype=torch.int32, device=device)
        de = torch.full((P, em), n_max[dt_], dtype=torch.int32,
                        device=device)
        et = torch.zeros((P, em), dtype=torch.int64, device=device)
        emk = torch.zeros((P, em), dtype=torch.bool, device=device)
        se[ep, k] = ext[sel].to(torch.int32)
        de[ep, k] = dl[sel].to(torch.int32)
        et[ep, k] = sel
        emk[ep, k] = True
        in_deg[dt_] += torch.bincount(dp_ * n_max[dt_] + dl,
                                      minlength=P * n_max[dt_]).float()
        src_ext[cet], dst_local[cet] = se, de
        eids_tbl[cet], e_mask[cet] = et.cpu().numpy(), emk.cpu().numpy()

    def host(d):
        return {k: v.cpu().numpy() for k, v in d.items()}

    return HeteroGraphShards(
        num_parts=P, ntypes=ntypes, cetypes=cetypes,
        n_max=n_max, h_max=h_max, e_max=e_max,
        ranges=host(ranges), order=host(order), new_of_old=host(new_of_old),
        send_idx=send_idx, send_mask=send_mask,
        src_ext=src_ext, dst_local=dst_local,
        in_deg={nt: v.reshape(P, n_max[nt]) for nt, v in in_deg.items()},
        eids_tbl=eids_tbl, e_mask=e_mask,
    )


def _hetero_run(mesh, shards, feats, axis, mean, eweights=None,
                halo_state=None):
    """Shared body of the fresh- and delayed-halo hetero SpMM.

    ``eweights``: optional {cetype: (P, e_max)} per-edge scalars laid out
    by ``shards.shard_edge_data``. ``halo_state``: optional {ntype: (L, P,
    h_max, F)} stale halo rows; when given, the local reductions read them
    while the fresh exchange runs, and the fresh rows are returned as the
    new state.
    """
    delayed = halo_state is not None
    ext_space, fresh = {}, {}
    for nt in shards.ntypes:
        x0 = mesh.local(feats[nt], axis)
        sb = _rows_of(x0, mesh.local(shards.send_idx[nt], axis)) * mesh.local(
            shards.send_mask[nt], axis)[..., None].to(x0.dtype)
        recv = mesh.all_to_all(sb, axis)
        fresh[nt] = recv
        use = mesh.local(halo_state[nt], axis) if delayed else recv
        L, Pn, hm, F = use.shape
        ext_space[nt] = torch.cat([x0, use.reshape(L, Pn * hm, F)], dim=1)
    outs = {}
    for cet in shards.cetypes:
        st, _, dt_ = cet
        msgs = _rows_of(ext_space[st], mesh.local(shards.src_ext[cet], axis))
        if eweights is not None and cet in eweights:
            msgs = msgs * mesh.local(eweights[cet], axis)[..., None]
        agg = _segment(msgs, mesh.local(shards.dst_local[cet], axis),
                       shards.n_max[dt_], "sum")
        outs[dt_] = agg if dt_ not in outs else outs[dt_] + agg
    res = {}
    for nt in shards.ntypes:
        o = outs.get(nt)
        if o is None:
            o = torch.zeros_like(mesh.local(feats[nt], axis))
        if mean:
            o = o / torch.clamp(mesh.local(shards.in_deg[nt], axis),
                                min=1.0)[..., None]
        res[nt] = o
    return (res, fresh) if delayed else res


def dist_hetero_copy_u_sum(mesh, shards: HeteroGraphShards,
                           feats: Dict[str, torch.Tensor],
                           axis: str = "gp", mean: bool = False,
                           eweights: Dict = None):
    """Per-etype halo-exchange SpMM, summed per destination type
    (``multi_update_all(copy_u, sum; cross sum)``; with ``eweights`` the
    message is ``u_mul_e``)."""
    return _hetero_run(mesh, shards, feats, axis, mean, eweights=eweights)


def init_hetero_halo_state(mesh, shards: HeteroGraphShards,
                           feat_dims: Dict[str, int], dtype=torch.float32,
                           axis: str = "gp"):
    """Zero halo cache per node type for the delayed aggregation."""
    return {nt: torch.zeros((mesh.parts(axis), shards.num_parts,
                             shards.h_max[nt], feat_dims[nt]), dtype=dtype,
                            device=mesh.device)
            for nt in shards.ntypes}


def dist_hetero_copy_u_sum_delayed(mesh, shards: HeteroGraphShards,
                                   feats: Dict[str, torch.Tensor],
                                   halo_state: Dict, axis: str = "gp",
                                   mean: bool = False, eweights: Dict = None):
    """Delayed-halo hetero aggregation: remote rows from the previous
    iteration's state. Returns ``(out_dict, new_halo_state)``."""
    return _hetero_run(mesh, shards, feats, axis, mean, eweights=eweights,
                       halo_state=halo_state)
