"""Shell decomposition of one edge direction (counterpart of
``dgl_tpu/ops/shell_spmm.py``).

Rank destinations by in-degree; the destinations with more than ``k``
in-edges then form a prefix of the rank order, so "the k-th in-edge of
every destination" is one flat gather added into a prefix: no scatter.
Levels at and beyond ``SHELL_CAP`` go to a block-padded residual reduced
by :func:`residual_reduce`.

This slice ports the builder, the residual reduction and the prefix
reduction that the hub SpMM's cold tail uses. The weighted shell g-SpMM
(``ShellSpMMPlan``, ``shell_gspmm_sum``) comes in a later slice.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["SHELL_CAP", "RES_BLOCK", "residual_reduce", "prefix_reduce"]

SHELL_CAP = 32  # max shell levels; deeper edges take the blocked residual
RES_BLOCK = 32  # residual rows per reduce block (see residual_reduce)


def _rup(x: int, m: int) -> int:
    return max(int(-(-x // m) * m), m)


def residual_reduce(rows, residual, n8):
    """Sum residual rows into the ranked accumulator.

    ``rows`` (R', *feat) already hold 0 in padded slots. Each rank
    position's run is padded to a multiple of RES_BLOCK at plan build, so
    the reduction is a reshape-sum over blocks followed by one sorted
    segment sum over the block partials. (The reference's max/min kinds
    serve the cmp shell g-SpMM, ROADMAP queue A3.)"""
    block_pos = residual[3].to(torch.int64)
    nb = block_pos.shape[0]
    r = rows.reshape((nb, RES_BLOCK) + tuple(rows.shape[1:]))
    part = r.sum(dim=1)
    return rows.new_zeros((n8,) + tuple(rows.shape[1:])).index_add(
        0, block_pos, part)


def prefix_reduce(pieces, n8, base=None):
    """Sum prefix-aligned contributions.

    ``pieces``: (m_k, *feat) tensors with non-increasing m_k, each added
    into ``out[:m_k]``; ``base``: optional full (n8, *feat) tensor. Rows no
    piece covers hold 0. The running sum is f32 whatever the pieces' type;
    it shrinks with the prefix and the finished tail segments are
    concatenated once at the end, base first and then level by level.
    Returns None when there is neither a piece nor a base. (The
    reference's max kind serves the cmp shell g-SpMM, ROADMAP queue A3.)"""
    segs = []
    R = base
    for rows in pieces:
        m = rows.shape[0]
        if R is None:
            if m < n8:
                segs.append(torch.zeros((n8 - m,) + tuple(rows.shape[1:]),
                                        dtype=torch.float32,
                                        device=rows.device))
            R = rows.to(torch.float32)
        elif m < R.shape[0]:
            segs.append(R[m:])
            R = R[:m] + rows.to(torch.float32)
        else:
            R = R + rows.to(torch.float32)
    if R is None:
        return None
    segs.append(R)
    if len(segs) == 1:
        return R
    return torch.cat(segs[::-1], dim=0)


def _build_dir(e_node: np.ndarray, e_to: np.ndarray, e_eid: np.ndarray,
               n_to: int, cap: int = SHELL_CAP, n_from=None, device="cpu"):
    """Shells of one direction: for each level k < ``cap``, the
    (gather-node, gather-eid, mask) triple of "the k-th incident edge of
    every ranked ``e_to`` node". Padded slots gather ``n_from`` (one past
    the table) when it is given, else 0.

    Levels >= ``cap`` go to the residual ``(nidx, eidx, pos_full,
    block_pos, mask)``: edges sorted by rank position, each position's run
    padded to a multiple of RES_BLOCK.

    Returns (shells, residual, unrank, rank) as tensors on ``device``;
    ``unrank``/``rank`` are None when the rank order is the identity (a
    graph relabelled by ``transforms.reorder_for_spmm``). Every sort is
    stable, so the arrays equal the reference's.
    """
    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    deg = np.bincount(e_to, minlength=n_to)
    rank = np.argsort(-deg, kind="stable").astype(np.int32)
    unrank = np.empty(n_to, np.int32)
    unrank[rank] = np.arange(n_to, dtype=np.int32)
    identity_unrank = bool(np.array_equal(unrank, np.arange(n_to)))
    order = np.argsort(e_to, kind="stable")
    en, et, ee = e_node[order], e_to[order], e_eid[order]
    starts = np.concatenate(([0], np.cumsum(np.bincount(et, minlength=n_to))))
    pos = np.arange(et.shape[0]) - starts[et]
    kmax = min(int(deg.max()) if et.size else 0, cap)
    h = np.bincount(np.minimum(deg, kmax), minlength=kmax + 1)
    n_ge = np.concatenate((np.cumsum(h[::-1])[::-1], [0]))
    rp = unrank[et]
    lo = pos < kmax
    lorder = np.lexsort((rp[lo], pos[lo]))
    en_l, ee_l, rp_l = en[lo][lorder], ee[lo][lorder], rp[lo][lorder]
    lstarts = np.concatenate(
        ([0], np.cumsum(np.bincount(pos[lo], minlength=kmax))))
    pad_id = np.int32(n_from if n_from is not None else 0)
    shells = []
    for k in range(kmax):
        a, b = int(lstarts[k]), int(lstarts[k + 1])
        n_k = int(n_ge[k + 1])
        n_k8 = _rup(n_k, 8)
        nidx = np.full(n_k8, pad_id, np.int32)
        eidx = np.zeros(n_k8, np.int32)
        nidx[rp_l[a:b]] = en_l[a:b]
        eidx[rp_l[a:b]] = ee_l[a:b]
        mask = np.zeros((n_k8, 1), np.float32)
        mask[:n_k, 0] = 1.0
        shells.append((dev(nidx), dev(eidx), dev(mask)))
    hi = ~lo
    R = int(hi.sum())
    un_out = None if identity_unrank else dev(unrank)
    rk_out = None if identity_unrank else dev(rank)
    if R == 0:
        return tuple(shells), None, un_out, rk_out
    B = RES_BLOCK
    horder = np.argsort(rp[hi], kind="stable")
    rp_r = rp[hi][horder]
    en_r = en[hi][horder]
    ee_r = ee[hi][horder]
    cnt = np.bincount(rp_r, minlength=n_to)
    nb = -(-cnt // B)
    base = np.concatenate(([0], np.cumsum(nb * B)))[:-1]
    off = np.arange(R) - np.concatenate(([0], np.cumsum(cnt)))[rp_r]
    slot = base[rp_r] + off
    Rp = int(nb.sum()) * B
    res_nidx = np.zeros(Rp, np.int32)
    res_eidx = np.zeros(Rp, np.int32)
    mask = np.zeros((Rp, 1), np.float32)
    res_nidx[slot] = en_r
    res_eidx[slot] = ee_r
    mask[slot, 0] = 1.0
    block_pos = np.repeat(np.arange(n_to, dtype=np.int32), nb)
    pos_full = np.repeat(block_pos, B)
    residual = (dev(res_nidx), dev(res_eidx), dev(pos_full),
                dev(block_pos), dev(mask))
    return tuple(shells), residual, un_out, rk_out
