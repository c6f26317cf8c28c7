"""Internal index helpers (reference ``python/dgl/utils/internal.py``)."""
from __future__ import annotations

import numpy as np
import torch

from .. import _host
from ..graph import _asnumpy

__all__ = ["toindex", "relabel"]


def toindex(x, dtype=np.int64):
    """Any id-like input (a tensor, an array, a list, a scalar) as a 1-D
    numpy int array."""
    return np.atleast_1d(_asnumpy(x)).astype(dtype)


def relabel(ids):
    """Unique + relabel map (reference ``utils.relabel``) through the host
    library's ``unique_and_compact``: the distinct ids in order of first
    occurrence and each id's index among them, as int64 tensors on the
    device of ``ids`` (the CPU for a host input). Raises where the library
    does not build."""
    device = ids.device if isinstance(ids, torch.Tensor) else "cpu"
    uniq, inv = _host.unique_and_compact(toindex(ids))
    return (torch.from_numpy(uniq).to(device),
            torch.from_numpy(inv).to(device))
