"""Small helpers (counterpart of ``dgl_tpu/sparse/utils_mod.py``;
reference ``python/dgl/sparse/utils.py``)."""
from __future__ import annotations

import numbers

import numpy as np
import torch

__all__ = ["is_scalar"]


def is_scalar(x) -> bool:
    """True for Python numbers and 0-dim arrays and tensors."""
    if isinstance(x, numbers.Number):
        return True
    if isinstance(x, (np.ndarray, torch.Tensor)):
        return x.ndim == 0
    return False
