"""The block sampler base (counterpart of
``dgl_tpu/dataloading/base.py:28-47``; reference
``python/dgl/dataloading/base.py:195``)."""
from __future__ import annotations

__all__ = ["BlockSampler"]


class BlockSampler:
    """Base of the samplers that produce lists of MFG blocks: subclasses
    implement ``sample_blocks(g, seed_nodes, exclude_eids=None) ->
    (input_nodes, output_nodes, blocks)``."""

    def sample_blocks(self, g, seed_nodes, exclude_eids=None):
        raise NotImplementedError

    def sample(self, g, seed_nodes, exclude_eids=None):
        return self.sample_blocks(g, seed_nodes, exclude_eids=exclude_eids)
