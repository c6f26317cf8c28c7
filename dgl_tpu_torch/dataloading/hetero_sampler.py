"""The heterogeneous fixed-shape neighbour sampler (counterpart of
``dgl_tpu/dataloading/hetero_sampler.py``).

Per layer, a fanout per canonical edge type; every node type gets a slot
space of a fixed size per layer, derived from the batch size and the
fanouts, its last slot the padding sink. So every batch gives blocks of
the same shapes. The picks run in ``csrc/host_ops.cpp``; the relabelling
is one first-occurrence unique a node type over its previous slots and
the layer's picks in edge-type order (``unique_and_compact``'s hash map).
Blocks go to ``device``.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from .. import _host
from ..base import EID, NID
from ..convert import create_block
from ..graph import Graph, _asnumpy
from ..sampling.neighbor import _fixed_host
from .base import BlockSampler

__all__ = ["HeteroFixedShapeNeighborSampler"]


class HeteroFixedShapeNeighborSampler(BlockSampler):
    """``fanouts``: a dict ``{etype: fanout}`` a layer, the innermost
    first. ``sample_blocks(g, seed_nodes)`` takes the seeds of
    ``seed_ntype`` (an array, or a dict holding them; at most
    ``batch_size``) and returns ``(input_nodes, output_nodes, blocks)``:
    the innermost slot ids by type (-1: padding), the seeds, and the
    blocks, whose ``srcdata``/``dstdata`` hold ``NID`` (padding: 0) and
    ``_mask`` and whose ``edata`` holds ``EID`` and ``_mask``. A layer
    draws a seed an edge type from the numpy generator made from ``seed``,
    in the reference's order, so the same seed gives its blocks."""

    def __init__(self, g: Graph, fanouts: Sequence[Dict], batch_size: int,
                 seed_ntype: str, replace: bool = False, seed=None,
                 device="cuda", **kwargs):
        super().__init__(**kwargs)
        self.fanouts = [{g.to_canonical_etype(k): v for k, v in
                         layer.items()} for layer in fanouts]
        self.batch_size = batch_size
        self.seed_ntype = seed_ntype
        self.replace = replace
        self.device = torch.device(device)
        self._rng = np.random.default_rng(seed)
        self._caps = self._compute_caps()

    def _compute_caps(self) -> List[Dict[str, int]]:
        """``caps[l][ntype]``: the slot count (the sink included) of layer
        ``l``'s source space; the last entry is the seed layer's."""
        L = len(self.fanouts)
        caps: List[Dict[str, int]] = [dict() for _ in range(L + 1)]
        caps[L] = {self.seed_ntype: self.batch_size + 1}
        for layer in range(L - 1, -1, -1):
            nxt = caps[layer + 1]
            cap = dict(nxt)  # the destinations lead their type's sources
            for (st, _, dt), f in self.fanouts[layer].items():
                if dt in nxt:
                    cap[st] = cap.get(st, 0) + (nxt[dt] - 1) * f
            caps[layer] = cap
        return caps

    @property
    def caps(self) -> List[Dict[str, int]]:
        """The slot counts by layer and node type (the seed layer last)."""
        return self._caps

    def sample_blocks(self, g: Graph, seed_nodes, exclude_eids=None):
        excl: Dict = {}
        if exclude_eids is not None:
            if not isinstance(exclude_eids, dict):
                raise TypeError("hetero exclude_eids must be {etype: eids}")
            excl = {g.to_canonical_etype(k): _asnumpy(v)
                    for k, v in exclude_eids.items()}
        if not isinstance(seed_nodes, dict):
            seed_nodes = {self.seed_ntype: seed_nodes}
        L = len(self.fanouts)
        arr = np.full(self._caps[L][self.seed_ntype], -1, np.int64)
        s = _asnumpy(seed_nodes[self.seed_ntype])[:self.batch_size]
        arr[:s.shape[0]] = s
        cur: Dict[str, np.ndarray] = {self.seed_ntype: arr}
        output_nodes = {k: torch.from_numpy(
            np.asarray(_asnumpy(v), np.int64)).to(self.device)
            for k, v in seed_nodes.items()}
        blocks = []
        for layer in range(L - 1, -1, -1):
            caps_src = self._caps[layer]
            # pass 1: the picks of each edge type into a sampled type
            picks = {}
            for cet, f in self.fanouts[layer].items():
                if cet[2] not in cur:
                    continue
                real = cur[cet[2]] >= 0
                nbr, eid, mask = _fixed_host(
                    g, cur[cet[2]][real], f, replace=self.replace, etype=cet,
                    seed=int(self._rng.integers(2**31)))
                ex = excl.get(cet)
                if ex is not None and ex.size:
                    mask = mask & ~np.isin(eid, ex)
                picks[cet] = (nbr, eid, mask, np.nonzero(real)[0], f)
            # pass 2: a type's slots, one first-occurrence unique over its
            # previous slots (padding: distinct negative ids) and its picks
            # in edge-type order; a node past the capacity keeps the sink
            src_ids, offsets = {}, {}
            for nt, cap in caps_src.items():
                prior = cur.get(nt)
                nprior = 0 if prior is None else prior.shape[0]
                sent = (np.where(prior >= 0, prior,
                                 -(np.arange(nprior, dtype=np.int64) + 2))
                        if prior is not None else np.zeros(0, np.int64))
                parts = [nbr[mask] for cet, (nbr, _, mask, _, _)
                         in picks.items() if cet[0] == nt]
                uniq, inv = _host.unique_and_compact(
                    np.concatenate([sent] + parts))
                ids = np.full(cap, -1, np.int64)
                keep = min(uniq.shape[0], cap - 1)
                ids[:keep] = uniq[:keep]
                if nprior:
                    ids[:nprior] = prior  # the -1 padding back
                src_ids[nt] = ids
                pos, offsets[nt] = nprior, {}
                for cet, (_, _, mask, _, _) in picks.items():
                    if cet[0] == nt:
                        cnt = int(mask.sum())
                        offsets[nt][cet] = inv[pos:pos + cnt]
                        pos += cnt
            # pass 3: the static edge arrays
            data, frames = {}, {}
            for cet, (nbr, eid, mask, slots, f) in picks.items():
                st, _, dt = cet
                cap_dst = cur[dt].shape[0]
                sink_src = caps_src[st] - 1
                e_cap = cap_dst * f
                esrc = np.full(e_cap, sink_src, np.int64)
                edst = np.full(e_cap, cap_dst - 1, np.int64)
                eids_out = np.zeros(e_cap, np.int64)
                emask = np.zeros(e_cap, bool)
                rows, cols = np.nonzero(mask)
                loc = offsets[st][cet]
                ok = loc < sink_src
                pos = slots[rows] * f + cols
                esrc[pos[ok]] = loc[ok]
                edst[pos[ok]] = slots[rows[ok]]
                eids_out[pos[ok]] = eid[mask][ok]
                emask[pos[ok]] = True
                data[cet] = (esrc, edst)
                frames[cet] = (eids_out, emask)
            block = create_block(
                data, num_src_nodes=dict(caps_src),
                num_dst_nodes={nt: a.shape[0] for nt, a in cur.items()},
                idtype=g.idtype, device=self.device)
            for cet in data:
                rel = block._relations[cet]
                rel.max_in_degree = rel.max_out_degree = rel.num_edges_padded

            def put(a):
                return torch.from_numpy(np.ascontiguousarray(a)).to(
                    self.device)

            for nt, sid in src_ids.items():
                block._node_frames.setdefault(nt, {}).update(
                    {NID: put(np.where(sid >= 0, sid, 0)),
                     "_mask": put(sid >= 0)})
            for nt, darr in cur.items():
                block._dst_frames.setdefault(nt, {}).update(
                    {NID: put(np.where(darr >= 0, darr, 0)),
                     "_mask": put(darr >= 0)})
            for cet, (eids_out, emask) in frames.items():
                block._edge_frames.setdefault(cet, {}).update(
                    {EID: put(eids_out), "_mask": put(emask)})
            blocks.insert(0, block)
            cur = src_ids
        return ({nt: torch.from_numpy(a).to(self.device)
                 for nt, a in cur.items()}, output_nodes, blocks)
