"""SubgraphSampler bases and the cooperative helpers (counterpart of
``dgl_tpu/graphbolt/subgraph_sampler.py``; reference
``python/dgl/graphbolt/subgraph_sampler.py``,
``impl/neighbor_sampler.py:555-639``, ``impl/cooperative_conv.py:12``).

The reference names are kept. ``all_to_all`` runs over
``torch.distributed``; the cooperative convolution needs the sparse
all-to-all of ``distributed/cooperative.py``, ROADMAP queue A11.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..graph import _asnumpy
from .minibatch import MiniBatch
from .neighbor_sampler_gb import (
    _COOPERATIVE,
    MiniBatchTransformer,
    NeighborSamplerStage,
    _Stage,
    exclude_seed_edges,
)

__all__ = [
    "SubgraphSampler",
    "NeighborSampler",
    "NeighborSamplerImpl",
    "SamplePerLayer",
    "CompactPerLayer",
    "TemporalNeighborSampler",
    "TemporalLayerNeighborSampler",
    "NegativeSampler",
    "SeedEdgesExcluder",
    "CooperativeConv",
    "CooperativeConvFunction",
    "all_to_all",
    "calculate_range",
    "count_split",
    "revert_to_homo",
    "convert_to_hetero",
]


class SubgraphSampler(MiniBatchTransformer):
    """Base of all subgraph samplers (reference
    ``subgraph_sampler.py:110``): subclasses implement
    ``sample_subgraphs(seeds)`` and the stage maps it over minibatches."""

    def __init__(self, source, *args, **kwargs):
        super().__init__(source, self._transform)

    def _transform(self, mb: MiniBatch) -> MiniBatch:
        seeds = mb.seeds
        mb.input_nodes, mb.sampled_subgraphs = self.sample_subgraphs(seeds)
        return mb

    def sample_subgraphs(self, seeds):
        raise NotImplementedError


# Reference class name for the fixed-shape neighbor stage
# (``impl/neighbor_sampler.py:472`` NeighborSampler).
NeighborSampler = NeighborSamplerStage
NeighborSamplerImpl = NeighborSamplerStage


class SamplePerLayer(_Stage):
    """One sampling hop over a FusedCSCSamplingGraph (reference
    ``impl/neighbor_sampler.py:334`` SamplePerLayer): appends this layer's
    :class:`SampledSubgraphImpl` to ``mb.sampled_subgraphs`` and replaces
    ``mb.input_nodes`` with the layer's frontier (seeds + sampled rows)."""

    def __init__(self, source, graph, fanout: int, replace: bool = False,
                 prob_name: Optional[str] = None,
                 seed: Optional[int] = None):
        super().__init__(source)
        self.graph = graph
        self.fanout = fanout
        self.replace = replace
        self.prob_name = prob_name
        self._seed = seed

    def _apply(self, mb: MiniBatch) -> MiniBatch:
        seeds = _asnumpy(
            mb.input_nodes if mb.input_nodes is not None else mb.seeds
        ).ravel()
        sub = self.graph.sample_neighbors(
            seeds, [self.fanout], replace=self.replace,
            probs_name=self.prob_name, seed=self._seed,
        )
        if mb.sampled_subgraphs is None:
            mb.sampled_subgraphs = []
        # outermost layer first, like the reference's insert(0, ...)
        mb.sampled_subgraphs.insert(0, sub)
        mb.input_nodes = np.unique(
            np.concatenate([seeds, sub.sampled_csc.indices])
        )
        return mb


class CompactPerLayer(_Stage):
    """Relabel the newest layer's rows to a contiguous space (reference
    ``impl/neighbor_sampler.py:460`` CompactPerLayer over C++
    unique_and_compact)."""

    def _apply(self, mb: MiniBatch) -> MiniBatch:
        from .base import unique_and_compact_csc_formats

        if not mb.sampled_subgraphs:
            return mb
        sub = mb.sampled_subgraphs[0]
        unique, compacted, _ = unique_and_compact_csc_formats(
            sub.sampled_csc, np.asarray(sub.original_column_node_ids)
        )
        sub.original_row_node_ids = unique
        sub.sampled_csc = compacted
        mb.input_nodes = unique
        return mb


class TemporalNeighborSampler(_Stage):
    """Timestamp-respecting neighbor sampling (reference
    ``impl/temporal_neighbor_sampler.py``): per layer, only edges/nodes no
    newer than each seed's timestamp are candidates."""

    def __init__(self, source, graph, fanouts: Sequence[int],
                 node_timestamp_attr: Optional[str] = None,
                 edge_timestamp_attr: Optional[str] = None,
                 replace: bool = False, seed: Optional[int] = None):
        super().__init__(source)
        self.graph = graph
        self.fanouts = list(fanouts)
        self.node_timestamp_attr = node_timestamp_attr
        self.edge_timestamp_attr = edge_timestamp_attr
        self.replace = replace
        self._seed = seed

    def _layer_fanouts(self):
        return self.fanouts

    def _apply(self, mb: MiniBatch) -> MiniBatch:
        seeds = _asnumpy(mb.seeds).ravel()
        if mb.timestamp is None:
            raise ValueError(
                "TemporalNeighborSampler needs mb.timestamp per seed"
            )
        stamps = _asnumpy(mb.timestamp)
        subs = []
        cur, cur_t = seeds, stamps
        for fanout in self._layer_fanouts():
            sub = self.graph.temporal_sample_neighbors(
                cur, cur_t, [fanout],
                node_timestamp_attr_name=self.node_timestamp_attr,
                edge_timestamp_attr_name=self.edge_timestamp_attr,
                replace=self.replace, seed=self._seed,
            )
            subs.insert(0, sub)
            # frontier for the next hop: sampled rows inherit their dst's
            # timestamp (reference broadcasts dst timestamps to srcs)
            deg = np.diff(np.asarray(sub.sampled_csc.indptr))
            nxt = np.asarray(sub.sampled_csc.indices)
            nxt_t = np.repeat(cur_t, deg)
            cur = np.concatenate([cur, nxt])
            cur_t = np.concatenate([cur_t, nxt_t])
        mb.sampled_subgraphs = subs
        mb.input_nodes = np.unique(cur)
        return mb


class TemporalLayerNeighborSampler(TemporalNeighborSampler):
    """Temporal LABOR variant (reference
    ``impl/temporal_neighbor_sampler.py`` layer_dependent=True): shares
    per-node uniforms across layers via a fixed seed so overlapping
    frontiers dedup, then applies the temporal mask."""

    def __init__(self, *args, **kwargs):
        kwargs.setdefault("seed", 0)
        super().__init__(*args, **kwargs)


class NegativeSampler(_Stage):
    """Base negative sampler (reference ``negative_sampler.py:15``):
    subclasses implement ``_sample_with_etype``."""

    def __init__(self, source, negative_ratio: int):
        super().__init__(source)
        self.negative_ratio = int(negative_ratio)

    def _apply(self, mb: MiniBatch) -> MiniBatch:
        mb = self._sample_with_etype(mb)
        return mb

    def _sample_with_etype(self, mb: MiniBatch) -> MiniBatch:
        raise NotImplementedError


class SeedEdgesExcluder(MiniBatchTransformer):
    """Stage form of :func:`exclude_seed_edges` (reference
    ``external_utils.py`` exclude_seed_edges wrapped in a transformer)."""

    def __init__(self, source, include_reverse_edges: bool = False):
        super().__init__(
            source,
            lambda mb: exclude_seed_edges(mb, include_reverse_edges),
        )


# -- cooperative minibatching helpers -----------------------------------------


def count_split(total: int, world_size: int, rank: int) -> int:
    """Size of rank's share when splitting ``total`` as evenly as possible
    (reference ``subgraph_sampler.py`` count partitioning)."""
    return total // world_size + (1 if rank < total % world_size else 0)


def calculate_range(total: int, world_size: int, rank: int):
    """[start, end) of rank's share under :func:`count_split`."""
    base = total // world_size
    rem = total % world_size
    start = rank * base + min(rank, rem)
    return start, start + count_split(total, world_size, rank)


class _Done:
    """The handle of a finished ``async_op`` collective."""

    def wait(self):
        return None


def all_to_all(outputs, inputs, group=None, async_op: bool = False):
    """Host all-to-all over ``torch.distributed`` (reference
    ``subgraph_sampler.py:41`` wraps ``torch.distributed.all_to_all``):
    entry ``j`` of ``inputs`` goes to process ``j``; ``outputs[j]``
    receives from process ``j``. ``outputs`` are writeable numpy arrays or
    CPU tensors. With one process, or no process group, a plain copy;
    otherwise the reference's all-gather and slice, through
    ``torch.distributed.all_gather`` (which gloo has; every rank's
    ``inputs[j]`` must share one shape)."""
    import torch.distributed as dist

    for o in outputs:
        if isinstance(o, torch.Tensor):
            if o.device.type != "cpu":
                raise TypeError("all_to_all outputs must be host buffers")
        elif not (isinstance(o, np.ndarray) and o.flags.writeable):
            raise TypeError("all_to_all outputs must be writeable numpy "
                            "arrays or CPU tensors")

    def put(out, value):
        if isinstance(out, torch.Tensor):
            out.copy_(torch.as_tensor(_asnumpy(value)))
        else:
            np.copyto(out, _asnumpy(value))

    ready = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size(group) if ready else 1
    if world == 1:
        for o, i in zip(outputs, inputs):
            put(o, i)
        return _Done() if async_op else None
    rank = dist.get_rank(group)
    for j in range(world):
        # every rank joins every gather, in order; only row j of our own
        # input's gather is ours to keep
        x = torch.as_tensor(_asnumpy(inputs[j])).contiguous()
        gathered = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(gathered, x, group=group)
        if j == rank:
            for src_rank in range(world):
                put(outputs[src_rank], gathered[src_rank])
    return _Done() if async_op else None


def revert_to_homo(d: dict):
    """Single-'_N'-keyed dict -> bare value (reference
    ``subgraph_sampler.py:87``)."""
    is_homogenous = isinstance(d, dict) and len(d) == 1 and "_N" in d
    return list(d.values())[0] if is_homogenous else d


def convert_to_hetero(item):
    """Bare value -> {'_N': value} (reference ``subgraph_sampler.py:93``)."""
    return item if isinstance(item, dict) else {"_N": item}


class CooperativeConvFunction:
    """Cross-rank activation redistribution for cooperative minibatching
    (reference ``impl/cooperative_conv.py:12``): ROADMAP queue A11."""

    @staticmethod
    def apply(mesh, ranges, table, ids, axis: str = "gp"):
        raise NotImplementedError(f"CooperativeConvFunction: {_COOPERATIVE}")


class CooperativeConv:
    """Module form of :class:`CooperativeConvFunction` (reference
    ``impl/cooperative_conv.py:96``): ROADMAP queue A11."""

    def __init__(self, mesh, axis: str = "gp"):
        raise NotImplementedError(f"CooperativeConv: {_COOPERATIVE}")


# Reference impl alias (``impl/temporal_neighbor_sampler.py``
# TemporalNeighborSamplerImpl is the stage body class).
TemporalNeighborSamplerImpl = TemporalNeighborSampler


def get_host_to_device_uva_stream():
    """CUDA-UVA copy stream handle (reference ``base.py``): None, as in
    the reference's build without UVA streams; the port copies on the
    consumer's current stream (``CopyTo``)."""
    return None


def get_device_to_host_uva_stream():
    """See :func:`get_host_to_device_uva_stream`."""
    return None


__all__ += [
    "TemporalNeighborSamplerImpl",
    "get_host_to_device_uva_stream",
    "get_device_to_host_uva_stream",
]
