"""Set-membership filter (reference ``python/dgl/utils/filter.py:7``,
C++ ``src/array/filter.cc``'s cuco-based GPU filter): ``torch.isin`` on the
id tensor's device."""
from __future__ import annotations

import torch

__all__ = ["Filter"]


class Filter:
    """Immutable id set supporting find_included/excluded_indices; the
    indices come out int64 on the tested tensor's device."""

    def __init__(self, ids):
        self._set = torch.unique(torch.as_tensor(ids))

    def _mask(self, test):
        test = torch.as_tensor(test)
        return torch.isin(test, self._set.to(test.device))

    def find_included_indices(self, test):
        return torch.nonzero(self._mask(test)).reshape(-1)

    def find_excluded_indices(self, test):
        return torch.nonzero(~self._mask(test)).reshape(-1)
