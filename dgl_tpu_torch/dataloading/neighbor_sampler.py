"""Neighbour samplers that produce MFG blocks (counterpart of
``dgl_tpu/dataloading/neighbor_sampler.py``; reference
``python/dgl/dataloading/neighbor_sampler.py``).

Two kinds:

- ``NeighborSampler`` (``MultiLayerNeighborSampler``),
  ``MultiLayerFullNeighborSampler`` and ``LaborSampler``: ragged blocks, as
  DGL's recipes use them. A layer picks with ``sampling.sample_neighbors``
  (``sample_labors``) and lays the block out as ``to_block`` does: the
  seeds first in the source space, then the other sources in order of
  first appearance, the edges in pick order. The block is built from the
  picks by ``to_block``'s own ``block_from_edges``, without the frontier
  subgraph over every node; the result is ``to_block(frontier, seeds)``'s,
  id for id and frame for frame.
- ``FixedShapeNeighborSampler``: every minibatch gives blocks of the same
  shapes, set by the batch size and the fanouts alone. A layer over
  ``cap_dst`` destination slots (the seeds, -1 marking a padding slot,
  the last slot the padding sink) has ``cap_src = cap_dst * (1 + fanout)``
  source slots, destinations first, and ``cap_dst * fanout`` edges: edge
  ``slot * fanout + j`` is the slot's ``j``-th pick, or a sink-to-sink
  padding edge. So the block's relation has a uniform stride of
  ``fanout`` and its reductions are masked reshapes (``ops/spmm.py``).
  One layer is sampled, deduplicated and relabelled by
  ``csrc/host_ops.cpp``'s ``build_padded_block`` (``_host.py``), or with
  ``prob`` picked by the weighted ``sample_neighbors_prob`` and relabelled
  here as the reference's loop does.

Blocks lie on the graph's device (the fixed-shape sampler's: its
``device``).
"""
from __future__ import annotations

from typing import Mapping, Optional, Sequence

import numpy as np
import torch

from .. import _host
from ..base import EID, NID, DGLError
from ..convert import create_block
from ..graph import Graph, _asnumpy, unique_first_occurrence
from ..sampling.labor import _labor_picks
from ..sampling.neighbor import _fixed_host, _index, _neighbor_picks, _put
from .base import BlockSampler

__all__ = ["NeighborSampler", "MultiLayerNeighborSampler",
           "MultiLayerFullNeighborSampler", "LaborSampler",
           "FixedShapeNeighborSampler"]


def _block_from_picks(g: Graph, picks: Mapping, seeds: Mapping) -> Graph:
    """``to_block(frontier, seeds)`` of the frontier ``edge_subgraph(g,
    picks, relabel_nodes=False)``, built from the picks without the
    frontier: ``picks`` holds a canonical edge type's picked edge ids,
    ``seeds`` a node type's destination ids."""
    from ..transforms.functional import block_from_edges, dst_slots

    empty = np.zeros(0, np.int64)
    kept = {}
    for cet in g.canonical_etypes:
        picked = np.asarray(picks.get(cet, empty), np.int64)
        src, dst = g._relations[cet].host_arrays("src", "dst")
        new_d = dst_slots(dst[picked], seeds.get(cet[2], empty),
                          g.num_nodes(cet[2]))
        keep = new_d >= 0  # edge_dir "out": only the edges into a seed
        picked = picked[keep]
        kept[cet] = (src[picked], new_d[keep], picked)
    # the frontier's EID is the pick's id in g (edge_subgraph's store_ids)
    return block_from_edges(g, seeds, kept, own_eids=True)


def _ragged_blocks(g: Graph, seed_nodes, fanouts, picks):
    """The blocks of the ragged samplers, innermost first: ``picks(seeds,
    fanout)`` gives a layer's picked edge ids by canonical edge type."""
    one_type = len(g.ntypes) == 1 and len(g.canonical_etypes) == 1
    if isinstance(seed_nodes, Mapping):
        seeds = {nt: np.atleast_1d(_asnumpy(v)).astype(np.int64)
                 for nt, v in seed_nodes.items()}
        if one_type:
            seeds = seeds[g.ntypes[0]]
    else:
        seeds = np.atleast_1d(_asnumpy(seed_nodes)).astype(np.int64)
    output_nodes = seeds
    blocks = []
    for fanout in reversed(fanouts):
        edges = picks(seeds, fanout)
        block = _block_from_picks(
            g, edges, seeds if isinstance(seeds, dict)
            else {g.ntypes[0]: seeds})
        seeds = {nt: _asnumpy(block._node_frames[nt][NID])
                 for nt in block.srctypes}
        if one_type:
            seeds = seeds[g.ntypes[0]]
        blocks.insert(0, block)

    def on_device(ids):
        if isinstance(ids, dict):
            return {k: _put(v, g.device) for k, v in ids.items()}
        return _put(ids, g.device)

    return on_device(seeds), on_device(output_nodes), blocks


class NeighborSampler(BlockSampler):
    """Multi-layer neighbour sampler of ragged blocks (reference
    ``dataloading/neighbor_sampler.py:11``). ``fanouts[0]`` is the
    innermost (input-side) layer; a layer draws its seed from the numpy
    generator made from ``seed``, outermost layer first, as the reference
    does. ``sample_blocks`` returns ``(input_nodes, output_nodes,
    blocks)``, the ids as int64 on the graph's device."""

    def __init__(self, fanouts: Sequence, edge_dir="in", prob=None,
                 replace=False, seed=None, **kwargs):
        super().__init__(**kwargs)
        self.fanouts = list(fanouts)
        self.edge_dir = edge_dir
        self.prob = prob
        self.replace = replace
        self._rng = np.random.default_rng(seed)

    def sample_blocks(self, g, seed_nodes, exclude_eids=None):
        return _ragged_blocks(
            g, seed_nodes, self.fanouts,
            lambda seeds, fanout: _neighbor_picks(
                g, seeds, fanout, self.edge_dir, self.prob, self.replace,
                exclude_eids, int(self._rng.integers(2**31))))


MultiLayerNeighborSampler = NeighborSampler


class MultiLayerFullNeighborSampler(NeighborSampler):
    """Every in-edge in every layer (reference
    ``MultiLayerFullNeighborSampler``)."""

    def __init__(self, num_layers: int, **kwargs):
        super().__init__([-1] * num_layers, **kwargs)


class LaborSampler(BlockSampler):
    """Multi-layer LABOR sampler of ragged blocks (reference
    ``dataloading/labor_sampler.py``): ``sampling.sample_labors`` a layer,
    ``importance_sampling`` its iterations."""

    def __init__(self, fanouts, edge_dir="in", prob=None,
                 importance_sampling=0, seed=None, **kwargs):
        super().__init__(**kwargs)
        self.fanouts = list(fanouts)
        self.edge_dir = edge_dir
        self.prob = prob
        self.importance_sampling = importance_sampling
        self._rng = np.random.default_rng(seed)

    def sample_blocks(self, g, seed_nodes, exclude_eids=None):
        if self.edge_dir != "in":
            raise NotImplementedError("labor sampling supports "
                                      "edge_dir='in'")
        return _ragged_blocks(
            g, seed_nodes, self.fanouts,
            lambda seeds, fanout: _labor_picks(
                g, seeds, fanout, self.prob, self.importance_sampling,
                int(self._rng.integers(2**31)))[0])


def _build_padded_block(g: Graph, seed_ids: np.ndarray, fanout: int,
                        rng: np.random.Generator, replace: bool,
                        prob: Optional[str]):
    """Sample one layer on the host: the (cap_src,) source ids (-1:
    padding) and the edges' sources, destinations, ids and mask. The graph
    must have one edge type (else ``DGLError``, as in the reference)."""
    rel = g._relation()
    if prob is None:
        indptr, indices, eids = _index(rel, "in")
        return _host.build_padded_block(indptr, indices, eids, seed_ids,
                                        fanout, replace,
                                        int(rng.integers(2**63)))
    real = np.nonzero(seed_ids >= 0)[0]
    nbr, eid, mask = _fixed_host(g, seed_ids[real], fanout, replace=replace,
                                 prob=prob, seed=int(rng.integers(2**31)))
    return _relabel_picks(seed_ids, real, nbr, eid, mask, fanout)


def _relabel_picks(seed_ids, real, nbr, eid, mask, fanout: int):
    """The padded layer of the picks ``(nbr, eid, mask)`` of the real
    slots ``real``, laid out as the reference's loop does: a pick equal to
    a seed takes the seed's first slot, a new node the next free slot
    after the destinations, in row-major pick order."""
    cap_dst = seed_ids.shape[0]
    sink = cap_dst - 1
    rows, cols = np.nonzero(mask)
    # padding slots become distinct negative ids, each its own node
    sent = np.where(seed_ids >= 0, seed_ids,
                    -(np.arange(cap_dst, dtype=np.int64) + 2))
    uniq, inv = unique_first_occurrence(
        np.concatenate([sent, nbr[rows, cols]]))
    # a distinct seed's slot: its first occurrence
    _, first = np.unique(inv[:cap_dst], return_index=True)
    n_seed = first.shape[0]
    loc = np.concatenate([first, cap_dst + np.arange(uniq.shape[0] - n_seed)])
    src_ids = np.full(cap_dst * (1 + fanout), -1, np.int64)
    src_ids[:cap_dst] = seed_ids
    src_ids[cap_dst:cap_dst + uniq.shape[0] - n_seed] = uniq[n_seed:]
    e_cap = cap_dst * fanout
    esrc = np.full(e_cap, sink, np.int64)
    edst = np.full(e_cap, sink, np.int64)
    eids = np.zeros(e_cap, np.int64)
    emask = np.zeros(e_cap, bool)
    slot = real[rows]
    pos = slot * fanout + cols
    esrc[pos] = loc[inv[cap_dst:]]
    edst[pos] = slot
    eids[pos] = eid[rows, cols]
    emask[pos] = True
    return src_ids, esrc, edst, eids, emask


def _mask_excluded_edges(esrc, edst, emask, eids, exclude_eids, sink):
    """Excluded edges keep their slots but are masked and rerouted to the
    padding sink, so shapes stay static and the reductions skip them
    (reference ``_mask_excluded_edges``; applied here before the block is
    built, which gives the reference's rebuilt relation)."""
    bad = np.isin(eids, _asnumpy(exclude_eids)) & emask
    if bad.any():
        esrc, edst = esrc.copy(), edst.copy()
        esrc[bad] = sink
        edst[bad] = sink
        emask = emask & ~bad
    return esrc, edst, emask


def _finalize_block(g: Graph, seed_ids, src_ids, esrc, edst, eids, emask,
                    device) -> Graph:
    """The block on ``device``: static degree bounds (``Ecap``, so every
    batch's relation looks alike) and the uniform stride; ``NID`` and
    ``_mask`` in the source and destination frames, ``EID`` and ``_mask``
    in the edge frame."""
    cap_dst, cap_src = seed_ids.shape[0], src_ids.shape[0]
    e_cap = esrc.shape[0]
    block = create_block((esrc, edst), num_src_nodes=cap_src,
                         num_dst_nodes=cap_dst, idtype=g.idtype,
                         device=device)
    rel = block._relation()
    rel.max_in_degree = rel.max_out_degree = e_cap
    rel.uniform_stride = cap_src // cap_dst - 1

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    block.srcdata[NID] = put(np.where(src_ids >= 0, src_ids, 0))
    block.srcdata["_mask"] = put(src_ids >= 0)
    block.dstdata[NID] = put(np.where(seed_ids >= 0, seed_ids, 0))
    block.dstdata["_mask"] = put(seed_ids >= 0)
    block.edata[EID] = put(eids)
    block.edata["_mask"] = put(emask)
    return block


class FixedShapeNeighborSampler(BlockSampler):
    """Static-shape multi-layer neighbour sampler (reference
    ``dgl_tpu.dataloading.FixedShapeNeighborSampler``).

    ``fanouts[0]`` is the innermost (input-side) layer. Batches of fewer
    than ``batch_size`` seeds are padded (``dstdata["_mask"]`` marks the
    real slots). Each layer draws one seed from the numpy generator made
    from ``seed``, innermost layer last, as the reference does: the same
    ``seed`` gives the same blocks. ``prob`` names an edge feature whose
    positive entries weight the picks. Blocks go to ``device``. The graph
    must have one edge type (which may join two node types).
    """

    def __init__(self, fanouts: Sequence[int], batch_size: int,
                 replace: bool = False, prob=None, seed=None,
                 device="cuda"):
        self.fanouts = list(fanouts)
        self.batch_size = int(batch_size)
        self.replace = replace
        self.prob = prob
        self.device = torch.device(device)
        self._rng = np.random.default_rng(seed)
        BlockSampler.__init__(self)

    def sample_blocks(self, g: Graph, seed_nodes, exclude_eids=None):
        """Sample the blocks of one batch: returns ``(input_ids,
        output_nodes, blocks)``, the innermost frontier's (cap_src,) ids
        with -1 padding and the seeds, both int64 on the device, and the
        blocks, innermost first."""
        seed_nodes = _asnumpy(seed_nodes).astype(np.int64)
        if seed_nodes.shape[0] > self.batch_size:
            raise DGLError(f"got {seed_nodes.shape[0]} seeds > batch_size "
                           f"{self.batch_size}")
        # the seeds, padded to batch_size, plus one sink slot
        cur = np.full(self.batch_size + 1, -1, dtype=np.int64)
        cur[:seed_nodes.shape[0]] = seed_nodes
        blocks = []
        for fanout in reversed(self.fanouts):
            src_ids, esrc, edst, eids, emask = _build_padded_block(
                g, cur, fanout, self._rng, self.replace, self.prob)
            if exclude_eids is not None:
                esrc, edst, emask = _mask_excluded_edges(
                    esrc, edst, emask, eids, exclude_eids, cur.shape[0] - 1)
            blocks.insert(0, _finalize_block(g, cur, src_ids, esrc, edst,
                                             eids, emask, self.device))
            cur = src_ids
        return (torch.from_numpy(cur).to(self.device),
                torch.from_numpy(seed_nodes).to(self.device), blocks)
