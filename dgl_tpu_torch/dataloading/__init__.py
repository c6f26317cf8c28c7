"""Minibatch dataloading (counterpart of ``dgl_tpu/dataloading/``;
reference ``python/dgl/dataloading/``).

Ported: the fixed-shape neighbour sampler, whose blocks have the same
shapes for every batch; the C++ block builder runs on the host and the
blocks are placed on the sampler's device. The ragged ``NeighborSampler``
and ``LaborSampler`` and the rest of the package are ROADMAP queue A9.
"""
from .base import BlockSampler
from .neighbor_sampler import FixedShapeNeighborSampler

__all__ = ["BlockSampler", "FixedShapeNeighborSampler"]
