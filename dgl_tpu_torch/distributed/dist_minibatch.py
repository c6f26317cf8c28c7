"""Distributed minibatch training: the DistDGL workflow over a mesh
(counterpart of ``dgl_tpu/distributed/dist_minibatch.py``; reference
``graph_services.py:737`` ``_distributed_access``, ``:1037``
``sample_neighbors``, ``dist_dataloader.py:792``).

- The graph is partitioned by destination owner (every in-edge of an
  owned node is local), nodes relabelled part-major
  (:class:`PartitionedGraphCSC`).
- Sampling runs on the host: each layer's frontier is grouped by owner
  part and each part answers from its local CSC through
  ``csrc/host_ops.cpp`` (the reference's native picks, the same for the
  same seeds), the RPC round trip replaced by direct host indexing.
- Input features stay on the device, row-sharded part-major, and are
  fetched with one masked request/response ``all_to_all`` pair
  (:func:`pull_rows_in_shard_map`): the KVStore pull as collectives.
- Each part trains on its own seeds (``node_split``); blocks are
  fixed-shape, so every step has one shape.

Ids are int64 here where the reference's are int32 (the values are equal).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from .. import _host
from ..base import DGLError
from ..graph import _asnumpy
from .cooperative import sparse_all_to_all_pull

__all__ = [
    "PartitionedGraphCSC",
    "DistNeighborSampler",
    "DistNodeDataLoader",
    "DistEdgeDataLoader",
    "DistEtypeNeighborSampler",
    "node_split_by_owner",
    "pull_rows_in_shard_map",
    "stack_blocks",
]


class _Int32Blocks:
    """The blocks' index type, as the reference's (int32)."""

    idtype = torch.int32


class PartitionedGraphCSC:
    """Host-side destination-partitioned CSC with part-major relabelling.

    Part ``p`` owns global (new) ids ``[ranges[p], ranges[p+1])`` and
    stores the in-edges of exactly those nodes (``indptr[p]`` over local
    destination rows, ``indices[p]`` holding GLOBAL source ids). The union
    of the parts is the graph, so owner-local sampling is exact.
    """

    def __init__(self, ranges, order, new_of_old, indptr, indices, eids):
        self.ranges = ranges                  # (P+1,)
        self.order = order                    # new -> old
        self.new_of_old = new_of_old          # old -> new
        self.indptr = indptr                  # list[P] of (n_p+1,)
        self.indices = indices                # list[P] of (E_p,) global new src
        self.eids = eids                      # list[P] of (E_p,) global eids
        self.num_parts = len(indptr)
        self.num_nodes = int(ranges[-1])

    @property
    def n_max(self) -> int:
        return int(max(ip.shape[0] - 1 for ip in self.indptr))

    @staticmethod
    def build(g, parts, num_parts: int) -> "PartitionedGraphCSC":
        """The parts of ``g`` under the assignment ``parts``. The
        relabelling and the stable sorts run in ``torch`` on the graph's
        device; the arrays, on the host, are the numpy build's."""
        device = g.device
        rel = g._relation(None)
        E = rel.num_edges
        n = g.num_nodes()
        P = int(num_parts)
        src = rel.src[:E].to(device=device, dtype=torch.int64)
        dst = rel.dst[:E].to(device=device, dtype=torch.int64)
        parts_t = torch.as_tensor(np.asarray(_asnumpy(parts), np.int64),
                                  device=device)
        order = torch.sort(parts_t, stable=True).indices
        new_of_old = torch.empty_like(order)
        new_of_old[order] = torch.arange(n, device=device)
        counts = torch.bincount(parts_t, minlength=P)
        ranges = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])
        src_new = new_of_old[src]
        del src
        dst_new = new_of_old[dst]
        del dst
        sel = torch.sort(dst_new, stable=True).indices
        deg = torch.bincount(dst_new, minlength=n)
        del dst_new
        src_sorted = src_new[sel]
        del src_new
        csum = torch.cat([deg.new_zeros(1), torch.cumsum(deg, 0)])
        ranges_np = ranges.cpu().numpy()
        csum_np = csum.cpu().numpy()
        src_np, sel_np = src_sorted.cpu().numpy(), sel.cpu().numpy()
        indptr, indices, eids = [], [], []
        for p in range(P):
            lo, hi = ranges_np[p], ranges_np[p + 1]
            ip = csum_np[lo:hi + 1]
            indptr.append(ip - ip[0])
            indices.append(src_np[ip[0]:ip[-1]])
            eids.append(sel_np[ip[0]:ip[-1]])
        return PartitionedGraphCSC(ranges_np, order.cpu().numpy(),
                                   new_of_old.cpu().numpy(), indptr,
                                   indices, eids)

    def _slots(self) -> np.ndarray:
        counts = np.diff(self.ranges)
        part = np.repeat(np.arange(self.num_parts), counts)
        return part * self.n_max + np.arange(self.num_nodes) - self.ranges[part]

    def shard_rows(self, x_old, device=None) -> torch.Tensor:
        """(N, ...) per-node data in OLD id order -> (P, n_max, ...)
        padded part-major shards (row ``i`` of part ``p`` is global new id
        ``ranges[p] + i``): the DistTensor layout the feature pull serves.
        On ``device``: ``x_old``'s for a tensor, else the card."""
        if device is None:
            device = x_old.device if isinstance(x_old, torch.Tensor) \
                else "cuda"
        x = torch.as_tensor(x_old).to(device)
        out = x.new_zeros((self.num_parts * self.n_max,) + x.shape[1:])
        out[torch.from_numpy(self._slots()).to(x.device)] = x[
            torch.from_numpy(self.order).to(x.device)]
        return out.reshape((self.num_parts, self.n_max) + x.shape[1:])

    def in_neighbors(self, node_new: int):
        """(global src ids, global eids) of one node: an owner-local
        lookup."""
        p = int(np.searchsorted(self.ranges, node_new, side="right") - 1)
        local = int(node_new - self.ranges[p])
        lo, hi = self.indptr[p][local], self.indptr[p][local + 1]
        return self.indices[p][lo:hi], self.eids[p][lo:hi]


def _layer(seed_ids, real, nbr, eid, mask, fanout: int, device):
    """The padded block of one layer's picks, relabelled as the
    reference's ``_assemble_block`` does: seeds keep their slots, new
    sources follow in row-major pick order."""
    from ..dataloading.neighbor_sampler import _finalize_block, \
        _relabel_picks

    src_ids, esrc, edst, eids, emask = _relabel_picks(
        seed_ids, real, nbr, eid, mask, fanout)
    block = _finalize_block(_Int32Blocks, seed_ids, src_ids, esrc, edst,
                            eids, emask, device)
    return block, src_ids


def _by_owner(pg, seed_ids):
    """The real slots of a frontier and each one's owner part."""
    real = np.nonzero(seed_ids >= 0)[0]
    owners = np.searchsorted(pg.ranges, seed_ids[real], side="right") - 1
    return real, owners


class DistNeighborSampler:
    """Fixed-shape multi-layer neighbour sampler over a partitioned graph.

    Each layer's frontier is grouped by owner part, and every owner
    answers from its local CSC, drawing one seed from the numpy generator
    a part in ascending part order, as the reference does. Blocks carry
    GLOBAL (part-major) ids in ``srcdata[NID]``, ready for the sharded
    feature pull, and go to ``device``.
    """

    def __init__(self, pg: PartitionedGraphCSC, fanouts: Sequence[int],
                 batch_size: int, replace: bool = False,
                 seed: Optional[int] = None, device="cuda"):
        self.pg = pg
        self.fanouts = list(fanouts)
        self.batch_size = batch_size
        self.replace = replace
        self.device = torch.device(device)
        self._rng = np.random.default_rng(seed)

    def _picks(self, seed_ids, width: int, pick):
        real, owners = _by_owner(self.pg, seed_ids)
        nbr = np.zeros((real.shape[0], width), np.int64)
        eid = np.zeros((real.shape[0], width), np.int64)
        mask = np.zeros((real.shape[0], width), bool)
        for p in np.unique(owners):
            at = np.nonzero(owners == p)[0]
            local = seed_ids[real[at]] - self.pg.ranges[p]
            nbr[at], eid[at], mask[at] = pick(
                int(p), local, int(self._rng.integers(2 ** 63)))
        return real, nbr, eid, mask

    def _sample_layer(self, seed_ids: np.ndarray, fanout: int):
        """One padded block, with owner-grouped neighbour picks."""
        pg = self.pg
        real, nbr, eid, mask = self._picks(
            seed_ids, fanout, lambda p, local, s: _host.sample_neighbors_fixed(
                pg.indptr[p], pg.indices[p], pg.eids[p], local, fanout,
                self.replace, s))
        return _layer(seed_ids, real, nbr, eid, mask, fanout, self.device)

    def _frontier(self, seed_nodes):
        seed_nodes = np.asarray(_asnumpy(seed_nodes)).astype(np.int64)
        if seed_nodes.shape[0] > self.batch_size:
            raise DGLError(
                f"{seed_nodes.shape[0]} seeds > batch_size {self.batch_size}")
        cur = np.full(self.batch_size + 1, -1, dtype=np.int64)
        cur[: seed_nodes.shape[0]] = seed_nodes
        return cur, seed_nodes

    def sample_blocks(self, seed_nodes):
        """seeds (global new ids) -> (input_nodes, output_nodes, blocks):
        the innermost frontier (host int64, -1 padding), the seeds, and
        the blocks, innermost first."""
        cur, output_nodes = self._frontier(seed_nodes)
        blocks = []
        for fanout in reversed(self.fanouts):
            block, cur = self._sample_layer(cur, fanout)
            blocks.insert(0, block)
        return cur, output_nodes, blocks


def node_split_by_owner(ids_new: np.ndarray, ranges: np.ndarray,
                        num_parts: int) -> List[np.ndarray]:
    """Split global (new) ids by owning part: ``node_split`` semantics
    (reference ``dist_graph.py:1558``)."""
    owner = np.searchsorted(ranges, ids_new, side="right") - 1
    return [ids_new[owner == p] for p in range(num_parts)]


def stack_blocks(per_rank_blocks):
    """P same-shape block lists (one a part, innermost first) -> one list
    a layer of the P parts' blocks, the loaders' layout (the reference
    stacks them into one pytree for ``shard_map``)."""
    return [list(layer) for layer in zip(*per_rank_blocks)]


def pull_rows_in_shard_map(mesh, ranges, table, ids, axis: str = "gp"):
    """Fetch rows of a part-major row-sharded table for arbitrary global
    ids: the KVStore pull of reference ``kvstore.py:1445`` as one masked
    request/response ``all_to_all`` pair. The reference's per-device body
    of ``cooperative.sparse_all_to_all_pull``; on a mesh the two are one
    function, so this is that pull: ``table`` (L, rows_max, F), ``ids``
    (L, B) global ids, returns (L, B, F), zeros for out-of-range ids."""
    return sparse_all_to_all_pull(mesh, ranges, table, ids, axis)


class DistNodeDataLoader:
    """Per-part seed iteration and fixed-shape blocks (reference
    ``DistDataLoader``/``DistNodeDataLoader``, ``dist_dataloader.py:792``).

    Every part draws batches from its own ``node_split`` share; short
    tails are padded so all parts step in lockstep. Yields
    ``(input_nodes (P, S), output_nodes (P, B), blocks)``, the ids int64
    on the sampler's device (-1 marks padding in ``output_nodes``) and
    ``blocks`` one list a layer of the P parts' blocks.
    """

    def __init__(self, pg: PartitionedGraphCSC, train_ids_new,
                 sampler: DistNeighborSampler, batch_size: int,
                 shuffle: bool = True, seed: Optional[int] = None):
        self.pg = pg
        self.sampler = sampler
        self.batch_size = batch_size
        self.shuffle = shuffle
        self._rng = np.random.default_rng(seed)
        self.splits = node_split_by_owner(
            np.asarray(_asnumpy(train_ids_new), dtype=np.int64),
            pg.ranges, pg.num_parts)
        self.steps_per_epoch = max(
            int(-(-len(s) // batch_size)) for s in self.splits)

    def __len__(self):
        return self.steps_per_epoch

    def __iter__(self):
        orders = [self._rng.permutation(s) if self.shuffle else np.asarray(s)
                  for s in self.splits]
        B = self.batch_size
        dev = self.sampler.device
        for step in range(self.steps_per_epoch):
            in_nodes, out_nodes, blocks = [], [], []
            for p in range(self.pg.num_parts):
                batch = orders[p][step * B: (step + 1) * B]
                cur, out, blks = self.sampler.sample_blocks(batch)
                in_nodes.append(np.where(cur >= 0, cur, 0))
                padded_out = np.full(B, -1, dtype=np.int64)
                padded_out[: out.shape[0]] = out
                out_nodes.append(padded_out)
                blocks.append(blks)
            yield (torch.from_numpy(np.stack(in_nodes)).to(dev),
                   torch.from_numpy(np.stack(out_nodes)).to(dev),
                   stack_blocks(blocks))


class DistEdgeDataLoader:
    """Distributed edge-prediction loader (reference
    ``dist_dataloader.py:843`` ``DistEdgeDataLoader``).

    Seeds are edges in the partitioned (new) id space, split by the
    destination's owner. Each step yields per-part stacked, fixed-shape
    int64 tensors on the device: ``pos (P, B, 2)`` positive pairs (-1
    padded), ``neg_dst (P, B, K)`` uniform negatives, ``seeds (P, S)`` the
    unique endpoints fed to the sampler (S = B*(2+K)+1, -1 padded),
    ``pos_idx (P, B, 2)`` / ``neg_idx (P, B, K)`` each endpoint's position
    in ``seeds``, ``input_nodes (P, S_in)``, and the blocks as
    :class:`DistNodeDataLoader`'s.
    """

    def __init__(self, pg: PartitionedGraphCSC, train_edges_new,
                 fanouts: Sequence[int], batch_size: int,
                 num_negatives: int = 1, shuffle: bool = True,
                 seed: Optional[int] = None, device="cuda"):
        edges = np.asarray(_asnumpy(train_edges_new), dtype=np.int64)
        if edges.ndim != 2 or edges.shape[1] != 2:
            raise DGLError("train_edges_new must be (E, 2) [src, dst] new ids")
        self.pg = pg
        self.batch_size = batch_size
        self.num_negatives = num_negatives
        self.shuffle = shuffle
        self._rng = np.random.default_rng(seed)
        owner = np.searchsorted(pg.ranges, edges[:, 1], side="right") - 1
        self.splits = [edges[owner == p] for p in range(pg.num_parts)]
        self.steps_per_epoch = max(
            int(-(-len(s) // batch_size)) for s in self.splits)
        seed_cap = batch_size * (2 + num_negatives)
        # the block sampler draws from ``seed`` too (the reference's is
        # unseeded), so every process samples the same blocks
        self.sampler = DistNeighborSampler(pg, fanouts, batch_size=seed_cap,
                                           seed=seed, device=device)

    def __len__(self):
        return self.steps_per_epoch

    def __iter__(self):
        B, K = self.batch_size, self.num_negatives
        n_total = int(self.pg.ranges[-1])
        dev = self.sampler.device
        orders = [self._rng.permutation(len(s)) if self.shuffle
                  else np.arange(len(s)) for s in self.splits]
        for step in range(self.steps_per_epoch):
            cols = [[] for _ in range(6)]
            blocks_r = []
            for p in range(self.pg.num_parts):
                sel = orders[p][step * B: (step + 1) * B]
                batch = self.splits[p][sel]
                nb = batch.shape[0]
                pos = np.full((B, 2), -1, dtype=np.int64)
                pos[:nb] = batch
                neg = self._rng.integers(0, n_total, size=(B, K))
                uniq = np.unique(np.concatenate([pos[:nb].ravel(),
                                                 neg[:nb].ravel()]))
                cur, _, blks = self.sampler.sample_blocks(uniq)
                pidx = np.where(pos >= 0,
                                np.searchsorted(uniq, np.maximum(pos, 0)), 0)
                nidx = np.searchsorted(uniq, neg)
                seeds_pad = np.full(self.sampler.batch_size + 1, -1,
                                    dtype=np.int64)
                seeds_pad[: uniq.shape[0]] = uniq
                for c, a in zip(cols, (pos, neg, seeds_pad, pidx, nidx,
                                       np.where(cur >= 0, cur, 0))):
                    c.append(a)
                blocks_r.append(blks)
            yield tuple(torch.from_numpy(np.stack(c).astype(np.int64)).to(dev)
                        for c in cols) + (stack_blocks(blocks_r),)


class DistEtypeNeighborSampler(DistNeighborSampler):
    """Per-edge-type fanout sampling over the homogenised partitioned
    graph (reference ``graph_services.py`` sample_etype_neighbors, the
    DistDGL hetero minibatch workflow, e.g. R-GCN on ogbn-mag).

    Each layer picks ``fanouts[t]`` in-edges of each type a seed. Blocks
    keep static shapes with a static per-slot etype layout: slot ``[seed,
    offs[t] + k]`` always holds a type-``t`` edge (masked when fewer
    exist), so the (E,) etypes array ``RelGraphConv`` reads is a constant.
    """

    def __init__(self, pg: PartitionedGraphCSC, type_per_edge,
                 etype_fanouts: Sequence[Sequence[int]], batch_size: int,
                 replace: bool = False, seed: Optional[int] = None,
                 device="cuda"):
        fanouts = [int(np.sum(f)) for f in etype_fanouts]
        super().__init__(pg, fanouts, batch_size, replace, seed, device)
        self.etype_fanouts = [np.asarray(f, np.int64) for f in etype_fanouts]
        self.type_per_edge = np.asarray(_asnumpy(type_per_edge), np.int64)

    def layer_caps(self):
        """cap_dst of each layer's block: the innermost (last) layer seeds
        ``batch_size + 1`` slots; each outer layer's destinations are the
        inner layer's source capacity ``cap * (1 + sum(fanouts))``."""
        caps = [0] * len(self.etype_fanouts)
        cap = self.batch_size + 1
        for layer in range(len(self.etype_fanouts) - 1, -1, -1):
            caps[layer] = cap
            cap = cap * (1 + int(self.etype_fanouts[layer].sum()))
        return caps

    def slot_etypes(self, layer: int, cap_dst: Optional[int] = None):
        """The static (Ecap,) per-slot etype array of one layer's block."""
        f = self.etype_fanouts[layer]
        if cap_dst is None:
            cap_dst = self.layer_caps()[layer]
        per_seed = np.repeat(np.arange(f.shape[0], dtype=np.int64), f)
        return np.tile(per_seed, cap_dst)

    def _sample_layer_etype(self, seed_ids: np.ndarray, fanouts):
        pg = self.pg
        fanouts = np.asarray(fanouts, np.int64)
        real, nbr, eid, mask = self._picks(
            seed_ids, int(fanouts.sum()),
            lambda p, local, s: _host.sample_neighbors_etype(
                pg.indptr[p], pg.indices[p], pg.eids[p], self.type_per_edge,
                fanouts, local, self.replace, s))
        return _layer(seed_ids, real, nbr, eid, mask, int(fanouts.sum()),
                      self.device)

    def sample_blocks(self, seed_nodes):
        cur, output_nodes = self._frontier(seed_nodes)
        blocks = []
        for layer in range(len(self.etype_fanouts) - 1, -1, -1):
            block, cur = self._sample_layer_etype(
                cur, self.etype_fanouts[layer])
            blocks.insert(0, block)
        return cur, output_nodes, blocks
