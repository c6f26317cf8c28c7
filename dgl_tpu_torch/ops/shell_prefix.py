"""Shell prefix sum: the cold-tail accumulation of the hub SpMM.

Counterpart of ``dgl_tpu/ops/shell_pallas.py``. The shell levels of a
rank-ordered graph are nested prefixes: level ``k`` holds "the k-th in-edge
of every node with in-degree > k", and those nodes are the first ``m_k``
rows. So the cold sum is

    out[r] = base[r] + sum_{k : r < m_k} table[idx_k[r]]

with no scatter. The index layout is the reference's: the levels' index
vectors concatenated, each padded to a multiple of ``BLOCK_ROWS`` with an
out-of-range index that gathers zero (:func:`flat_shell_indices`).

:func:`shell_prefix_sum` runs the hand-written CUDA kernel
(``dgl_tpu_torch/csrc/shell_prefix_sum.cu``, which fuses the gather the
TPU kernel could not) on a CUDA tensor, and the plain PyTorch version
:func:`shell_prefix_sum_plain` on a CPU tensor. Both sum in f32, base first
and then level by level, so on the same inputs they agree to the bit.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import _kernels
from .shell_spmm import _rup, prefix_reduce

__all__ = ["flat_shell_indices", "level_table", "shell_prefix_sum",
           "shell_prefix_sum_plain"]

BLOCK_ROWS = 512  # level padding of the flat layout (shell_pallas._BR)


def _piece_rows(level_rows):
    """Length of the reference's index stream: the block-padded levels plus
    one trailing all-padding block (the last value of the TPU kernel's
    ``_grid_vectors``, which the port's kernel does not need)."""
    nb = sum(int(-(-m // BLOCK_ROWS)) for m in level_rows)
    return (nb + 1) * BLOCK_ROWS


def flat_shell_indices(shell_indices, n_out, oob_index):
    """The level-concatenated, block-padded index vector plus the level row
    counts. ``shell_indices``: per-level int32 index tensors of
    non-increasing length whose padded slots already hold ``oob_index``.
    ``n_out`` keeps the reference's signature; the layout does not depend
    on it."""
    level_rows = [int(idx.shape[0]) for idx in shell_indices]
    piece_rows = _piece_rows(level_rows)
    segs = []
    for idx, m in zip(shell_indices, level_rows):
        idx = idx.to(torch.int32)
        pad = _rup(m, BLOCK_ROWS) - m
        segs.append(idx if pad == 0 else torch.cat(
            [idx, idx.new_full((pad,), oob_index)]))
    total = sum(int(s.shape[0]) for s in segs)
    if piece_rows > total:
        dev = shell_indices[0].device if shell_indices else "cpu"
        segs.append(torch.full((piece_rows - total,), oob_index,
                               dtype=torch.int32, device=dev))
    flat = torch.cat(segs) if len(segs) > 1 else segs[0]
    return flat, level_rows


def level_table(level_rows, device):
    """(2, K) int64 tensor: each level's offset into the flat index vector,
    then its row count. The kernel reads it on the device."""
    rows = np.asarray(level_rows, np.int64)
    padded = np.asarray([_rup(m, BLOCK_ROWS) for m in level_rows], np.int64)
    off = np.concatenate(([0], np.cumsum(padded)[:-1])).astype(np.int64)
    return torch.from_numpy(np.stack([off, rows])).to(device)


def shell_prefix_sum_plain(table, flat_idx, level_rows, n_out, base=None):
    """Plain PyTorch version: a zero-row-appended ``index_select`` per
    level, then an f32 add into the level's prefix. Indices outside
    ``[0, len(table))`` gather the zero row."""
    n, feat = table.shape
    padded = torch.cat([table, table.new_zeros((1, feat))])
    idx = flat_idx.to(torch.int64)
    idx = torch.where((idx < 0) | (idx >= n), n, idx)
    pieces, off = [], 0
    for m in level_rows:
        pieces.append(padded.index_select(0, idx[off:off + min(m, n_out)]))
        off += _rup(m, BLOCK_ROWS)
    if base is not None:
        base = base[:n_out].to(torch.float32)
    out = prefix_reduce(pieces, n_out, base=base)
    if out is None:
        return torch.zeros((n_out, feat), dtype=torch.float32,
                           device=table.device)
    return out


def shell_prefix_sum(table, flat_idx, level_rows, n_out, base=None,
                     levels=None):
    """``out[r] = base[r] + sum_{k : r < m_k} float(table[idx[off_k + r]])``.

    ``table``: (N, F) bf16 feature table. ``flat_idx``: int32 layout of
    :func:`flat_shell_indices`. ``level_rows``: the ``m_k``. ``base``:
    optional (>= n_out, F) f32. ``levels``: the :func:`level_table` of
    ``level_rows`` on the table's device (built here when not given).
    Returns (n_out, F) f32.

    A CUDA table runs the kernel; a CPU table runs the plain version.
    """
    if table.device.type == "cpu":
        return shell_prefix_sum_plain(table, flat_idx, level_rows, n_out,
                                      base=base)
    if not table.is_cuda:
        raise ValueError(f"shell_prefix_sum: unsupported device "
                         f"{table.device}")
    return _launch(table, flat_idx, level_rows, n_out, base, levels)


def _launch(table, flat_idx, level_rows, n_out, base, levels):
    dev = table.device
    if table.dtype != torch.bfloat16 or table.dim() != 2:
        raise ValueError(f"table must be 2-D bf16, got {table.dtype} "
                         f"{tuple(table.shape)}")
    if flat_idx.dtype != torch.int32 or flat_idx.device != dev:
        raise ValueError("flat_idx must be int32 on the table's device")
    if levels is None:
        levels = level_table(level_rows, dev)
    if (levels.dtype != torch.int64 or levels.device != dev
            or tuple(levels.shape) != (2, len(level_rows))):
        raise ValueError("levels must be the (2, K) int64 level_table")
    n, feat = table.shape
    need = sum(_rup(int(m), BLOCK_ROWS) for m in level_rows[:-1]) + (
        min(int(level_rows[-1]), n_out) if level_rows else 0)
    if need > flat_idx.shape[0]:
        raise ValueError("flat_idx is shorter than its level layout")
    table = table.contiguous()
    flat_idx = flat_idx.contiguous()
    levels = levels.contiguous()
    if base is not None:
        if (base.dtype != torch.float32 or base.device != dev
                or base.dim() != 2 or base.shape[1] != feat
                or base.shape[0] < n_out):
            raise ValueError("base must be (>= n_out, F) f32 on the table's "
                             "device")
        base = base[:n_out].contiguous()
    out = torch.empty((n_out, feat), dtype=torch.float32, device=dev)
    ptrs = [table.data_ptr(), out.data_ptr()]
    if base is not None:
        ptrs.append(base.data_ptr())
    vec = 8 if feat % 8 == 0 and all(p % 16 == 0 for p in ptrs) else 1
    lib = _kernels.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.dgl_shell_prefix_sum(
            table.data_ptr(), n, feat, flat_idx.data_ptr(),
            levels[0].data_ptr(), levels[1].data_ptr(), len(level_rows),
            None if base is None else base.data_ptr(), out.data_ptr(),
            n_out, vec, stream)
    _kernels.check(code, "shell_prefix_sum")
    _kernels.launch_counts["shell_prefix_sum"] += 1
    return out
