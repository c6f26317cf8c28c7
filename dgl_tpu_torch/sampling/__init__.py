"""Sampling (counterpart of ``dgl_tpu/sampling/``; reference
``python/dgl/sampling/``): the host samplers (neighbour, LABOR, random
walks, negative pairs, PinSAGE), whose picks run in ``csrc/host_ops.cpp``
or host numpy and whose results land on the graph's device, and the
on-device neighbour sampler."""
from .device_sampler import (DeviceMFG, DeviceNeighborSampler,
                             device_seed_batches)
from .labor import sample_labors
from .negative import global_uniform_negative_sampling
from .neighbor import (in_subgraph_sample, sample_etype_neighbors,
                       sample_neighbors, sample_neighbors_biased,
                       sample_neighbors_fixed, sample_neighbors_fused,
                       select_topk, temporal_sample_neighbors)
from .pinsage import PinSAGESampler, RandomWalkNeighborSampler
from .randomwalks import node2vec_random_walk, pack_traces, random_walk
from .utils import EidExcluder

__all__ = [
    "DeviceMFG", "DeviceNeighborSampler", "device_seed_batches",
    "sample_neighbors", "sample_neighbors_fixed", "sample_etype_neighbors",
    "sample_neighbors_fused", "EidExcluder", "in_subgraph_sample",
    "temporal_sample_neighbors", "select_topk", "sample_neighbors_biased",
    "random_walk", "node2vec_random_walk", "pack_traces",
    "global_uniform_negative_sampling", "sample_labors", "PinSAGESampler",
    "RandomWalkNeighborSampler",
]
