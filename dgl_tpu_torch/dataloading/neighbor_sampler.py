"""The fixed-shape neighbour sampler (counterpart of
``dgl_tpu/dataloading/neighbor_sampler.py:125-305``).

Every minibatch gives blocks of the same shapes, set by the batch size and
the fanouts alone. A layer over ``cap_dst`` destination slots (the seeds,
-1 marking a padding slot, the last slot the padding sink) has
``cap_src = cap_dst * (1 + fanout)`` source slots, destinations first as
the reference's ``to_block`` lays them out, and ``cap_dst * fanout``
edges: edge ``slot * fanout + j`` is the slot's ``j``-th pick, or a
sink-to-sink padding edge. So the block's relation has a uniform stride
of ``fanout`` and its reductions are masked reshapes (``ops/spmm.py``).

One layer is sampled, deduplicated and relabelled by ``csrc/host_ops.cpp``'s
``build_padded_block`` (``_host.py``); the block is then built on the host
and placed on the sampler's device.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from .. import _host
from ..base import EID, NID, DGLError
from ..convert import create_block
from ..graph import Graph, _asnumpy
from .base import BlockSampler

__all__ = ["FixedShapeNeighborSampler"]


def _build_padded_block(g: Graph, seed_ids: np.ndarray, fanout: int,
                        rng: np.random.Generator, replace: bool,
                        prob: Optional[str]):
    """Sample one layer on the host: the (cap_src,) source ids (-1:
    padding) and the edges' sources, destinations, ids and mask."""
    if prob is not None:
        raise NotImplementedError(
            "weighted fixed-shape sampling (prob=...): "
            "sampling.neighbor.sample_neighbors_fixed, ROADMAP queue A9")
    indptr, indices, eids = _host.csc_int64(g._relation())
    return _host.build_padded_block(indptr, indices, eids, seed_ids, fanout,
                                    replace, int(rng.integers(2**63)))


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
    real slots). Each layer draws one 63-bit seed from the numpy generator
    made from ``seed``, innermost layer last, as the reference does: the
    same ``seed`` gives the same blocks. Blocks go to ``device``.
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

    def sample_blocks(self, g: Graph, seed_nodes, exclude_eids=None):
        """Sample the blocks of one batch: returns ``(input_ids,
        output_nodes, blocks)``, the innermost frontier's (cap_src,) ids
        with -1 padding and the seeds, both int64 on the device, and the
        blocks, innermost first."""
        if not g.is_homogeneous:
            raise NotImplementedError(
                "heterogeneous sampling (several node or edge types): "
                "ROADMAP queue A9")
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
