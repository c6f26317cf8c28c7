"""Padded chunk-tree segmented reduction (counterpart of
``dgl_tpu/ops/chunk_tree.py``).

Reduces rows sorted by segment without a scatter: pad each segment's run
to a multiple of ``W``, gather the rows (an out-of-range slot reads 0),
reshape to (M / W, W, F) and sum the middle axis, then recurse on the
per-chunk sums until every segment is one row. The reduction is a
balanced tree, so its f32 error grows as O(log E). The output lands in
segment order.

``build_tree_levels`` is the JAX package's host (numpy) build, unchanged;
``tree_segment_sum`` is plain PyTorch (the reference's is plain JAX; no
module of either package calls it).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

__all__ = ["build_tree_levels", "tree_segment_sum"]


def _rup(x: int, m: int) -> int:
    return max(int(-(-x // m) * m), m)


def build_tree_levels(
    seg_counts: np.ndarray,
    W: int = 16,
    level0_values: np.ndarray | None = None,
    level0_oob: int | None = None,
) -> Tuple[Tuple[np.ndarray, ...], int]:
    """Host build: per-level gather index arrays for a chunk tree.

    ``seg_counts``: (n_out,) run length of each segment (data sorted by
    segment id). Level-0 slots index into the data array unless
    ``level0_values`` is given, in which case slot values are composed
    through it (e.g. the cold-edge source ids, fusing the tree's level-0
    gather with the SpMM's feature-table gather). Out-of-bounds slots get
    ``len(data)`` (or ``level0_oob``), which ``tree_segment_sum``'s
    gather reads as 0.

    Returns (levels, W); each level is an int32 array whose length is a
    multiple of W.
    """
    n_out = seg_counts.shape[0]
    levels = []
    cur = seg_counts.astype(np.int64)
    cur_len = int(cur.sum())
    first = True
    while True:
        padded = np.maximum(-(-cur // W), 1) * W
        m = int(padded.sum())
        start = np.concatenate(([0], np.cumsum(cur)))[:-1]
        pstart = np.concatenate(([0], np.cumsum(padded)))[:-1]
        oob = cur_len if not (first and level0_oob is not None) else level0_oob
        idx = np.full(m, oob, np.int32)
        seg_of = np.repeat(np.arange(n_out, dtype=np.int64), cur)
        off = np.arange(cur_len, dtype=np.int64) - start[seg_of]
        vals = np.arange(cur_len, dtype=np.int32)
        if first and level0_values is not None:
            vals = level0_values.astype(np.int32)
        idx[pstart[seg_of] + off] = vals
        levels.append(idx)
        cur = padded // W
        cur_len = m // W
        first = False
        if int(cur.max() if cur.size else 0) <= 1:
            break
    return tuple(levels), W


def tree_segment_sum(levels: Sequence, W: int, rows: torch.Tensor,
                     n_out: int) -> torch.Tensor:
    """Reduce ``rows`` (the level-0 table; level-0 indices may point into
    it directly or through a fused composition, see
    ``build_tree_levels``) to (n_out, F) segment sums, on ``rows``'s
    device. A bf16 table's level-0 gather accumulates in f32."""
    x = rows
    for k, idx in enumerate(levels):
        idx = torch.as_tensor(idx, device=x.device).long()
        n = x.shape[0]
        idx = torch.where((idx < 0) | (idx >= n), n, idx)
        padded = torch.cat([x, x.new_zeros((1,) + tuple(x.shape[1:]))])
        g = padded.index_select(0, idx)
        if k == 0 and g.dtype != torch.float32:
            g = g.float()
        x = g.reshape((-1, W) + tuple(x.shape[1:])).sum(1)
    return x[:n_out]
