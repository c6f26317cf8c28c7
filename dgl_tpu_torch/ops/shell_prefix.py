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
:func:`shell_prefix_sum_plain` on a CPU tensor. The table is bf16 (the hub
plan's ``cold="shell"``) or f32 (``"shell-f32"``: the TPU kernel casts
each piece block to f32, so it takes either); the kernel has an
instantiation for each. Both sum in f32, base first and then level by
level, so on the same inputs they agree to the bit.

:func:`shell_prefix_gspmm` is B1's weighted caller (the reference's
``shell_spmm._shell_accumulate``, which builds the message stream with XLA
ops and hands it to the same Pallas kernel). Its kernel,
``dgl_shell_prefix_gspmm`` in the same source, gathers a node row and an
edge row per slot and fuses the message too:

    out[r] = base[r]
             + sum_{k : r < n_k} f32(round_gd(op(u[nidx_k[r]], e[eidx_k[r]])))

with ``n_k`` each level's real row count: the weighted plan's padded slots
gather row 0 and edge 0, which are real data, so the walk stops by the
count, not by the index. Given the plan's ``rank`` (rank position to
node), it stores row ``r`` at ``rank[r]``, so the rows come out in node
order with no unrank gather after it. :func:`shell_prefix_gspmm_plain` is
its plain version, with the same sums in the same order.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _kernels
from .shell_spmm import (SHELL_CAP, _expand, _msg, _out_feat, _rup,
                         prefix_reduce)

__all__ = ["flat_shell_indices", "level_table", "shell_prefix_sum",
           "shell_prefix_sum_plain", "shell_prefix_gspmm",
           "shell_prefix_gspmm_plain"]

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


def level_table(level_rows, device, counts=None):
    """(2, K) int64 tensor: each level's offset into the flat index vector,
    then its row count (``counts`` in place of ``level_rows`` where given:
    the weighted kernel's real row counts). The kernel reads it on the
    device."""
    rows = np.asarray(level_rows if counts is None else counts, np.int64)
    padded = np.asarray([_rup(m, BLOCK_ROWS) for m in level_rows], np.int64)
    off = (np.cumsum(padded) - padded).astype(np.int64)
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

    ``table``: (N, F) bf16 or f32 feature table. ``flat_idx``: int32 layout of
    :func:`flat_shell_indices`. ``level_rows``: the ``m_k``. ``base``:
    optional (>= n_out, F) f32. ``levels``: the :func:`level_table` of
    ``level_rows`` on the table's device (built here when not given).
    On the card at most ``SHELL_CAP`` levels, their sizes non-increasing.
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


_TABLE_TYPES = {torch.bfloat16: "shell_prefix_sum",
                torch.float32: "shell_prefix_sum_f32"}


def _launch(table, flat_idx, level_rows, n_out, base, levels):
    dev = table.device
    if table.dtype not in _TABLE_TYPES or table.dim() != 2:
        raise ValueError(f"table must be 2-D bf16 or f32, got {table.dtype} "
                         f"{tuple(table.shape)}")
    if flat_idx.dtype != torch.int32 or flat_idx.device != dev:
        raise ValueError("flat_idx must be int32 on the table's device")
    if len(level_rows) > SHELL_CAP:
        raise ValueError(f"{len(level_rows)} levels: the kernel takes at "
                         f"most SHELL_CAP = {SHELL_CAP}")
    if any(b > a for a, b in zip(level_rows, level_rows[1:])):
        raise ValueError("level_rows must not increase: the levels are "
                         "nested prefixes")
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
            table.data_ptr(), int(table.dtype == torch.bfloat16), n, feat,
            flat_idx.data_ptr(),
            levels[0].data_ptr(), levels[1].data_ptr(), len(level_rows),
            None if base is None else base.data_ptr(), out.data_ptr(),
            n_out, vec, stream)
    name = _TABLE_TYPES[table.dtype]
    _kernels.check(code, name)
    _kernels.launch_counts[name] += 1
    return out


# ---------------------------------------------------------------------------
# the weighted caller: the message built in the kernel
# ---------------------------------------------------------------------------

_OPS = {"add": 0, "sub": 1, "mul": 2, "div": 3, "copy_lhs": 4,
        "copy_rhs": 5}


def _check_layout(nidx, level_rows, level_real, n_out):
    if not level_rows and not level_real:
        return
    if len(level_rows) != len(level_real) or any(
            c > m for c, m in zip(level_real, level_rows)):
        raise ValueError("level_real must give at most level_rows rows a "
                         "level")
    if len(level_rows) > SHELL_CAP:
        raise ValueError(f"{len(level_rows)} levels: the kernel takes at "
                         f"most SHELL_CAP = {SHELL_CAP}")
    if any(b > a for a, b in zip(level_real, level_real[1:])):
        raise ValueError("level_real must not increase: the levels are "
                         "nested prefixes")
    need = sum(_rup(int(m), BLOCK_ROWS) for m in level_rows[:-1]) + (
        min(int(level_real[-1]), n_out) if level_rows else 0)
    if need > nidx.shape[0]:
        raise ValueError("the flat indices are shorter than their level "
                         "layout")


def _check_rank(rank, n_out, device):
    """Raise unless ``rank`` is an int32 permutation of the ``n_out`` rows
    on ``device``. The permutation test reads the device, so a tensor
    remembers the version counter it passed at (a plan's rank is tested
    on its first call, and again only after an in-place change)."""
    if (rank.dtype != torch.int32 or rank.device != device
            or rank.dim() != 1 or rank.shape[0] != n_out):
        raise ValueError(f"rank must be a 1-D int32 vector of n_out = "
                         f"{n_out} rows on the tables' device")
    version = None if rank.is_inference() else rank._version
    if version is not None and getattr(rank, "_permutation_at",
                                       None) == version:
        return
    if not torch.equal(torch.sort(rank).values, torch.arange(
            n_out, dtype=torch.int32, device=device)):
        raise ValueError("rank must be a permutation of range(n_out)")
    if version is not None:
        rank._permutation_at = version


def shell_prefix_gspmm_plain(op, lhs, rhs, nidx, eidx, level_rows,
                             level_real, n_out, base=None, rank=None):
    """Plain PyTorch version of :func:`shell_prefix_gspmm`: per level, the
    gathers, the message in the tables' type, a select of the level's
    ``n_k`` real rows, then an f32 add into the prefix (``prefix_reduce``,
    base first); with ``rank``, row ``r`` copied to ``rank[r]``."""
    feat = _out_feat(op, lhs, rhs)
    ref = lhs if lhs is not None else rhs
    pieces, off = [], 0
    for m8, m in zip(level_rows, level_real):
        mm = min(int(m8), n_out)
        ul = None if lhs is None else lhs.index_select(
            0, nidx[off:off + mm].long())
        el = None if rhs is None else rhs.index_select(
            0, eidx[off:off + mm].long())
        rows = _msg(op, ul, el)
        keep = torch.arange(mm, device=rows.device) < m
        # where, not a product: a padded slot's message may be inf or NaN
        pieces.append(torch.where(_expand(keep, rows.dim()), rows,
                                  0).to(torch.float32))
        off += _rup(int(m8), BLOCK_ROWS)
    if base is not None:
        base = base[:n_out].to(torch.float32)
    out = prefix_reduce(pieces, n_out, base=base)
    if out is None:
        return torch.zeros((n_out,) + feat, dtype=torch.float32,
                           device=ref.device)
    if rank is None:
        return out
    return torch.empty_like(out).index_copy_(0, rank.long(), out)


def shell_prefix_gspmm(op, lhs, rhs, nidx, eidx, level_rows, level_real,
                       n_out, base=None, levels=None, rank=None):
    """``out[rank[r]] = base[r] + sum_{k : r < n_k} f32(op(lhs[nidx_k[r]],
    rhs[eidx_k[r]]))``, the message computed in the tables' type.

    ``lhs`` (N, ...) and ``rhs`` (E, ...): bf16 or f32 tables of one type
    (either None for the copy ops), broadcast like ``gspmm``'s operands.
    ``nidx``/``eidx``: int32 flat layouts of :func:`flat_shell_indices`.
    ``level_rows``: the levels' padded lengths (``n_k8``); ``level_real``:
    their real row counts (``n_k``). ``base``: optional (>= n_out, *feat)
    f32. ``levels``: the ``level_table(level_rows, device,
    counts=level_real)`` on the tables' device (built here when not given).
    ``rank``: optional int32 permutation of the ``n_out`` rows (the plan's
    ``rank_dst``/``rank_src``); without it row ``r`` stays at ``r``.
    At most ``SHELL_CAP`` levels, their real counts non-increasing.
    Returns (n_out, *feat) f32.

    A CUDA table runs the kernel; a CPU table runs the plain version.
    """
    if op not in _OPS:
        raise ValueError(f"unknown op {op!r}")
    if (lhs is None) != (op == "copy_rhs") or (rhs is None) != (
            op == "copy_lhs"):
        raise ValueError(f"op {op!r} takes "
                         + {"copy_lhs": "lhs only", "copy_rhs": "rhs only"}
                         .get(op, "lhs and rhs"))
    _check_layout(nidx, level_rows, level_real, n_out)
    ref = lhs if lhs is not None else rhs
    if ref.device.type not in ("cpu", "cuda"):
        raise ValueError(f"shell_prefix_gspmm: unsupported device "
                         f"{ref.device}")
    if rank is not None:
        _check_rank(rank, n_out, ref.device)
    if ref.device.type == "cpu":
        return shell_prefix_gspmm_plain(op, lhs, rhs, nidx, eidx,
                                        level_rows, level_real, n_out,
                                        base=base, rank=rank)
    return _launch_gspmm(op, lhs, rhs, nidx, eidx, level_rows, level_real,
                         n_out, base, levels, rank)


def _broadcast(shape, out):
    """How an operand of feature shape ``shape`` (right-padded to
    ``out``'s rank) reads output column ``j`` of the flattened ``out``:
    ``(kind, div, mod)`` with column ``(j // div) % mod``. Kind 0: the
    whole row (``j``); 1: one value a row; 2: one contiguous run of
    ``out``'s dims, the others broadcast. None for any other pattern."""
    dims = [(s, o) for s, o in zip(shape, out) if o != 1]
    present = [i for i, (s, o) in enumerate(dims) if s == o]
    if not present:
        return 1, 1, 1
    lo, hi = present[0], present[-1]
    if present != list(range(lo, hi + 1)):
        return None
    mod = int(np.prod([o for _s, o in dims[lo:hi + 1]], dtype=np.int64))
    div = int(np.prod([o for _s, o in dims[hi + 1:]], dtype=np.int64))
    return (0 if div == 1 and lo == 0 else 2), div, mod


def _operands(op, lhs, rhs):
    """The message's feature shape and each operand's ``_broadcast``
    pattern (``(1, 1, 1)`` for the one a copy op does not read)."""
    ref = lhs if lhs is not None else rhs
    dtype = ref.dtype
    if dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"tables must be bf16 or f32, got {dtype}")
    for t in (lhs, rhs):
        if t is not None and (t.dtype != dtype or t.device != ref.device
                              or t.dim() < 1):
            raise ValueError("lhs and rhs must be tables of one type on one "
                             "device")
    feat = _out_feat(op, lhs, rhs)
    nd = len(feat)
    pattern = []
    for t in (lhs, rhs):
        if t is None:
            pattern.append((1, 1, 1))
            continue
        shape = tuple(t.shape[1:]) + (1,) * (nd - (t.dim() - 1))
        p = _broadcast(shape, feat)
        if p is None:
            raise ValueError(
                f"shell_prefix_gspmm: unsupported broadcast of lhs "
                f"{None if lhs is None else tuple(lhs.shape)} and rhs "
                f"{None if rhs is None else tuple(rhs.shape)}: an operand's "
                f"non-broadcast dims must be one contiguous run")
        pattern.append(p)
    return feat, pattern


def _launch_gspmm(op, lhs, rhs, nidx, eidx, level_rows, level_real, n_out,
                  base, levels, rank):
    ref = lhs if lhs is not None else rhs
    dev = ref.device
    dtype = ref.dtype
    feat, pattern = _operands(op, lhs, rhs)
    for t in (nidx, eidx):
        if t.dtype != torch.int32 or t.device != dev:
            raise ValueError("nidx and eidx must be int32 on the tables' "
                             "device")
    D = int(np.prod(feat, dtype=np.int64))
    if levels is None:
        levels = level_table(level_rows, dev, counts=level_real)
    if (levels.dtype != torch.int64 or levels.device != dev
            or tuple(levels.shape) != (2, len(level_rows))):
        raise ValueError("levels must be the (2, K) int64 level_table")
    lhs = None if lhs is None else lhs.contiguous()
    rhs = None if rhs is None else rhs.contiguous()
    nidx, eidx, levels = nidx.contiguous(), eidx.contiguous(), \
        levels.contiguous()
    if base is not None:
        if (base.dtype != torch.float32 or base.device != dev
                or base.shape[0] < n_out or tuple(base.shape[1:]) != feat):
            raise ValueError("base must be (>= n_out, *feat) f32 on the "
                             "tables' device")
        base = base[:n_out].reshape(n_out, D).contiguous()
    out = torch.empty((n_out, D), dtype=torch.float32, device=dev)
    ptrs = [out.data_ptr()] + [t.data_ptr() for t, (kind, _d, _m) in zip(
        (lhs, rhs), pattern) if t is not None and kind == 0]
    if base is not None:
        ptrs.append(base.data_ptr())
    vec = 8 if D % 8 == 0 and all(p % 16 == 0 for p in ptrs) else 1
    args = []
    for t, (kind, div, mod) in zip((lhs, rhs), pattern):
        args += [None if t is None else t.data_ptr(), kind, div, mod]
    lib = _kernels.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.dgl_shell_prefix_gspmm(
            _OPS[op], int(dtype == torch.bfloat16), *args,
            nidx.data_ptr(), eidx.data_ptr(), levels[0].data_ptr(),
            levels[1].data_ptr(), len(level_rows),
            None if rank is None else rank.contiguous().data_ptr(),
            None if base is None else base.data_ptr(), out.data_ptr(),
            n_out, D, vec, stream)
    _kernels.check(code, "shell_prefix_gspmm")
    _kernels.launch_counts["shell_prefix_gspmm"] += 1
    return out.reshape((n_out,) + feat)


def gspmm_occupancy(op, lhs, rhs, n_levels):
    """What the card runs a :func:`shell_prefix_gspmm` launch over these
    tables and ``n_levels`` levels with (16-byte aligned tables assumed):
    the compiled kernel's registers, static shared bytes and local (stack
    and spill) bytes a thread, the block's threads and dynamic shared
    bytes, the blocks an SM holds, and the instantiation (``kernel``, as
    ``chip_smoke.ptxas_key`` names it)."""
    feat, pattern = _operands(op, lhs, rhs)
    D = int(np.prod(feat, dtype=np.int64))
    vec = 8 if D % 8 == 0 else 1
    bf16 = (lhs if lhs is not None else rhs).dtype == torch.bfloat16
    out = (ctypes.c_int * 7)()
    code = _kernels.library().dgl_shell_prefix_gspmm_occupancy(
        _OPS[op], int(bf16), vec, pattern[0][0], pattern[1][0], D, n_levels,
        ctypes.addressof(out))
    _kernels.check(code, "shell_prefix_gspmm_occupancy")
    keys = ("registers", "static_smem_bytes", "local_bytes_per_thread",
            "threads_per_block", "dynamic_smem_bytes", "blocks_per_sm")
    return {**dict(zip(keys, out)),
            "kernel": f"gspmm T={'bf16' if bf16 else 'f32'} vec={vec} "
                      f"op={op} fast={out[6]}"}
