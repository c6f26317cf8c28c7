"""Farthest point sampling (counterpart of ``dgl_tpu/geometry/fps.py``;
reference ``python/dgl/geometry/fps.py:11``, C++ ``src/geometry/``).

On the points' device, all clouds at once: ``npoints - 1`` steps, each a
distance update and an ``argmax`` (the first index on a tie, as
``jnp.argmax``). A squared distance sums the coordinates' squares left to
right, each an elementwise op, so the card and the CPU round it alike."""
from __future__ import annotations

import torch

__all__ = ["farthest_point_sampler"]


def farthest_point_sampler(pos, npoints: int, start_idx=None, *,
                           device=None) -> torch.Tensor:
    """The indices of ``npoints`` points of each cloud, each the farthest
    from those picked before it, starting at ``start_idx`` (default 0):
    ``pos`` (B, N, C) or (N, C) gives (B, npoints) or (npoints,) int64, on
    ``device`` (default: ``pos``'s own if a tensor, else the card)."""
    from ..transforms.functional import _points_device

    pos = torch.as_tensor(pos, device=_points_device(pos, device))
    squeeze = pos.dim() == 2
    if squeeze:
        pos = pos[None]
    B, N, C = pos.shape
    out = torch.zeros((B, npoints), dtype=torch.int64, device=pos.device)
    if start_idx is not None:
        out[:, 0] = int(start_idx)
    dists = torch.full((B, N), torch.inf, dtype=pos.dtype, device=pos.device)
    rows = torch.arange(B, device=pos.device)
    for i in range(1, npoints):
        diff = pos - pos[rows, out[:, i - 1]][:, None, :]
        sq = diff * diff
        d = sq[..., 0]
        for c in range(1, C):
            d = d + sq[..., c]
        dists = torch.minimum(dists, d)
        out[:, i] = torch.argmax(dists, dim=1)
    return out[0] if squeeze else out
