"""Negative samplers for edge prediction (counterpart of
``dgl_tpu/dataloading/negative_sampler.py``; reference
``python/dgl/dataloading/negative_sampler.py``)."""
from __future__ import annotations

import numpy as np

from ..graph import _asnumpy

__all__ = ["Uniform", "GlobalUniform", "PerSourceUniform"]


class _BaseNegativeSampler:
    def __call__(self, g, eids):
        return self._generate(g, _asnumpy(eids))


class Uniform(_BaseNegativeSampler):
    """``k`` negatives an edge: its source with a destination drawn
    uniformly from the generator made from ``seed`` (reference
    ``Uniform``). Returns host int64 ``(src, dst)``."""

    def __init__(self, k: int, seed=None):
        self.k = k
        self._rng = np.random.default_rng(seed)

    def _generate(self, g, eids):
        src = g._relation(None).host_arrays("src")[0][eids]
        src = np.repeat(src, self.k).astype(np.int64)
        dst = self._rng.integers(0, g.num_nodes(), src.shape[0])
        return src, dst


PerSourceUniform = Uniform


class GlobalUniform(_BaseNegativeSampler):
    """``k`` negatives an edge drawn over the whole graph, existing edges
    rejected (reference ``GlobalUniform``;
    ``sampling.global_uniform_negative_sampling``)."""

    def __init__(self, k: int, exclude_self_loops=True, replace=False,
                 redundancy=1.3, seed=None):
        self.k = k
        self.exclude_self_loops = exclude_self_loops
        self.replace = replace
        self.redundancy = redundancy
        self._seed = seed

    def _generate(self, g, eids):
        from ..sampling import global_uniform_negative_sampling

        return global_uniform_negative_sampling(
            g, self.k * eids.shape[0],
            exclude_self_loops=self.exclude_self_loops,
            replace=self.replace, redundancy=self.redundancy,
            seed=self._seed)
