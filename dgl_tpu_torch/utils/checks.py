"""Shape/type helpers (reference ``python/dgl/utils/checks.py``)."""
from __future__ import annotations

from ..base import DGLError
from ..nn.conv.graphconv import expand_as_pair  # canonical location

__all__ = ["expand_as_pair", "check_eq_shape"]


def check_eq_shape(feat):
    if isinstance(feat, tuple) and feat[0].shape[1:] != feat[1].shape[1:]:
        raise DGLError(
            f"feature shape mismatch: {feat[0].shape} vs {feat[1].shape}"
        )
