"""Global RNG seeding (counterpart of ``dgl_tpu/random_mod.py``; reference
``python/dgl/random.py`` ``dgl.seed``), exposed as
``dgl_tpu_torch.random``.

One numpy ``default_rng`` stream, as the JAX package's: after the same
``seed``, ``choice`` and ``next_seed`` draw the same values in both
packages. ``seed`` does not seed torch, as the reference's does not seed
JAX.
"""
from __future__ import annotations

import numpy as np

__all__ = ["seed", "get_rng", "next_seed", "choice"]

_rng = np.random.default_rng(0)


def seed(val: int):
    """Set the global host RNG seed (reference ``random.py`` ``seed``)."""
    global _rng
    _rng = np.random.default_rng(val)


def get_rng() -> np.random.Generator:
    return _rng


def next_seed() -> int:
    """Draw a fresh sampler seed from the global stream."""
    return int(_rng.integers(2**63))


def choice(a, size, replace=True, prob=None):
    """``numpy.random.choice`` over the framework RNG (reference
    ``python/dgl/random.py:21``); ``prob`` may be a tensor."""
    p = None
    if prob is not None:
        p = np.asarray(prob.detach().cpu() if hasattr(prob, "detach")
                       else prob)
        s = p.sum()
        if s <= 0:
            raise ValueError("prob must have positive mass")
        p = p / s
    return get_rng().choice(a, size=size, replace=replace, p=p)
