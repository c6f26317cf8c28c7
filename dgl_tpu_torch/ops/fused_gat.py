"""Fused GAT attention in shell (rank) space (counterpart of
``dgl_tpu/ops/fused_gat.py``).

The reference's GATConv runs attention as three separate passes, each
materialising per-edge tensors in eid order: g-SDDMM ``u_add_v`` logits,
the edge softmax, the ``u_mul_e`` g-SpMM (``gatconv.py:337-346``). This op
never leaves shell space. Each level gathers every edge's source row once,
packed as ``[el | h]`` in the plan's gather dtype; ``er`` is a prefix read
in rank space, with no per-edge gather:

  logits  : ``leaky_relu(el[src] + er_rank)``;
  softmax : the running max, then the exp-sum, over the shrinking
            prefixes (``prefix_reduce``; the residual through
            ``residual_reduce``);
  apply   : ``alpha * h[src]`` in the same walk, summed into the prefix.

The backward is the reference's hand-derived one (``_fused_bwd``): one pass
in destination rank space (``c = sum alpha_m * dalpha`` and ``der``) and
one in source rank space over the reverse shells (``dh`` and ``del``, with
everything that travels from destination to source packed into one row
``[er | mx | s | c | dz]``). It recomputes the gathers from ``el``, ``er``,
``h`` and the saved ``mx`` and ``s``; no per-edge tensor is saved.

The JAX package computes this op with XLA operations and no Pallas kernel,
so the port computes it with PyTorch operations. bf16 rounds where the
reference rounds: the packed rows, ``alpha`` before ``alpha * h``, the
cotangent and the packed reverse rows, and the per-head dot products of
bf16 rows (computed in f32, rounded to bf16, as XLA computes a bf16
``einsum``).

``drop_mask``: an optional (E, H) multiplier in eid order applied to the
normalised attention (dropout after the softmax, no renormalisation, the
reference's ``attn_drop``), gathered through each level's ``eidx`` in both
directions so the forward and both backward passes see the same mask.
"""
from __future__ import annotations

import torch

from .shell_spmm import (ShellSpMMPlan, _has_residual, _rup, prefix_reduce,
                         residual_reduce)

__all__ = ["fused_gat_attention"]


def _leaky(x, slope):
    return torch.where(x > 0, x, x * slope)


def _dleaky(x, slope):
    one = torch.ones((), dtype=x.dtype, device=x.device)
    return torch.where(x > 0, one, torch.full_like(one, slope))


def _ranked(x, rank):
    """Node-order table -> rank-order table (one N-level gather)."""
    return x if rank is None else x.index_select(0, rank)


def _unranked(x_ranked, unrank, n):
    return x_ranked[:n] if unrank is None else x_ranked.index_select(
        0, unrank)


def _pad_rows(x, n8):
    """Pad a ranked table to the accumulator height plus one zero row, which
    the residual's padding positions read harmlessly."""
    pad = n8 + 1 - x.shape[0]
    return torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])


def _gd(plan):
    return torch.bfloat16 if plan.gather_dtype == "bf16" else torch.float32


def _src_pack(plan, el, h):
    """One (N_src, H + H*O) table in the gather dtype: ``[el | h.flat]``."""
    gd = _gd(plan)
    return torch.cat([el.to(gd), h.reshape(h.shape[0], -1).to(gd)], dim=1)


def _src_rows(packed, H, HO, nidx):
    rows = packed.index_select(0, nidx)
    return (rows[:, :H].to(torch.float32),
            rows[:, H:].reshape((rows.shape[0],) + tuple(HO)))


def _head_dot(a, b, gd):
    """``einsum("eho,eho->eh", a, b)`` of two gd tables, computed in f32 and
    rounded to gd, then returned in f32."""
    return (a.to(torch.float32) * b.to(torch.float32)).sum(-1).to(gd).to(
        torch.float32)


def _fwd_impl(slope, plan, el, er, h, drop_mask=None):
    gd = _gd(plan)
    n8 = _rup(plan.num_dst, 8)
    er_rank = _pad_rows(_ranked(er, plan.rank_dst).to(torch.float32), n8)
    packed = _src_pack(plan, el, h)
    H, HO = el.shape[1], h.shape[1:]
    res = plan.res_dst

    # one packed gather per level, reused by all three passes
    gathered = [_src_rows(packed, H, HO, nidx) for nidx, _e, _m in plan.shells]
    raws = [el_g + er_rank[: el_g.shape[0]] for el_g, _ in gathered]
    g_res = raw_res = None
    if _has_residual(res):
        g_res = _src_rows(packed, H, HO, res[0])
        raw_res = g_res[0] + er_rank.index_select(0, res[2])

    # pass 1: running max
    pieces = [torch.where(mask > 0, _leaky(raw, slope), -torch.inf)
              for (_n, _e, mask), raw in zip(plan.shells, raws)]
    base = None
    if raw_res is not None:
        rows = torch.where(res[4] > 0, _leaky(raw_res, slope), -torch.inf)
        base = residual_reduce(rows, res, n8, "max")
    mx = prefix_reduce(pieces, n8, base=base, kind="max")
    if mx is None:
        return (h.new_zeros((plan.num_dst,) + tuple(h.shape[1:])), None,
                None)
    mx = torch.where(torch.isfinite(mx), mx, 0.0)
    mx_pad = _pad_rows(mx, n8)

    # pass 2: exp-sum
    pieces = [torch.where(mask > 0,
                          torch.exp(_leaky(raw, slope) - mx[: raw.shape[0]]),
                          0.0)
              for (_n, _e, mask), raw in zip(plan.shells, raws)]
    base = None
    if raw_res is not None:
        rows = torch.where(
            res[4] > 0,
            torch.exp(_leaky(raw_res, slope) - mx_pad.index_select(0, res[2])),
            0.0)
        base = residual_reduce(rows, res, n8, "sum")
    s = torch.clamp(prefix_reduce(pieces, n8, base=base), min=1e-38)
    s_pad = torch.clamp(_pad_rows(s, n8), min=1e-38)

    # pass 3: alpha * h accumulated
    pieces = []
    for (_n, eidx, mask), raw, (_el_g, h_g) in zip(plan.shells, raws,
                                                   gathered):
        m = raw.shape[0]
        alpha = torch.exp(_leaky(raw, slope) - mx[:m]) / s[:m]
        alpha = torch.where(mask > 0, alpha, 0.0)
        if drop_mask is not None:
            alpha = alpha * drop_mask.index_select(0, eidx)
        pieces.append((alpha.to(gd)[..., None] * h_g).to(torch.float32))
    base = None
    if raw_res is not None:
        r_pos = res[2]
        alpha = torch.where(
            res[4] > 0,
            torch.exp(_leaky(raw_res, slope) - mx_pad.index_select(0, r_pos))
            / s_pad.index_select(0, r_pos), 0.0)
        if drop_mask is not None:
            alpha = alpha * drop_mask.index_select(0, res[1])
        base = residual_reduce(
            (alpha.to(gd)[..., None] * g_res[1]).to(torch.float32), res, n8,
            "sum")
    acc = prefix_reduce(pieces, n8, base=base)
    out = _unranked(acc, plan.unrank_dst, plan.num_dst).to(h.dtype)
    return out, mx, s


def _fused_bwd(slope, plan, el, er, h, mx, s, drop_mask, dz):
    gd = _gd(plan)
    n8d = _rup(plan.num_dst, 8)
    n8s = _rup(plan.num_src, 8)
    H, HO = el.shape[1], h.shape[1:]
    er_rank = _pad_rows(_ranked(er, plan.rank_dst).to(torch.float32), n8d)
    dz_rank = _pad_rows(_ranked(dz.to(gd), plan.rank_dst), n8d)
    res = plan.res_dst
    mx_pad = _pad_rows(mx, n8d)
    s_pad = torch.clamp(_pad_rows(s, n8d), min=1e-38)
    packed = _src_pack(plan, el, h)

    def drop(alpha, eidx):
        return alpha if drop_mask is None else (
            alpha * drop_mask.index_select(0, eidx))

    def alpha_dalpha(raw, mask, h_g, mx_rows, s_rows, dz_rows):
        # select, do not multiply: a padded slot's gather can overflow exp
        # to inf, and inf times a 0 mask is NaN
        alpha = torch.where(
            mask > 0, torch.exp(_leaky(raw, slope) - mx_rows) / s_rows, 0.0)
        return alpha, _head_dot(dz_rows, h_g, gd)

    # destination space: one packed gather per level, reused twice. With
    # dropout after the softmax (y = sum (a*m) h), dlogit = (a*m)*dalpha -
    # a*c where c = sum (a*m)*dalpha: the -a*c term takes the undropped a
    shell_ad, pieces = [], []
    for nidx, eidx, mask in plan.shells:
        m = nidx.shape[0]
        el_g, h_g = _src_rows(packed, H, HO, nidx)
        raw = el_g + er_rank[:m]
        alpha, dalpha = alpha_dalpha(raw, mask, h_g, mx[:m], s[:m],
                                     dz_rank[:m])
        alpha_m = drop(alpha, eidx)
        shell_ad.append((raw, alpha, alpha_m, dalpha))
        pieces.append(alpha_m * dalpha)
    base = None
    res_ad = None
    if _has_residual(res):
        r_pos = res[2]
        el_g, h_g = _src_rows(packed, H, HO, res[0])
        raw_r = el_g + er_rank.index_select(0, r_pos)
        alpha_r, dalpha_r = alpha_dalpha(
            raw_r, res[4], h_g, mx_pad.index_select(0, r_pos),
            s_pad.index_select(0, r_pos), dz_rank.index_select(0, r_pos))
        alpha_rm = drop(alpha_r, res[1])
        res_ad = (raw_r, alpha_r, alpha_rm, dalpha_r)
        base = residual_reduce(alpha_rm * dalpha_r, res, n8d, "sum")
    c = prefix_reduce(pieces, n8d, base=base)
    c_pad = _pad_rows(c, n8d)

    pieces = [(alpha_m * dalpha - alpha * c[: raw.shape[0]])
              * _dleaky(raw, slope)
              for raw, alpha, alpha_m, dalpha in shell_ad]
    base = None
    if res_ad is not None:
        raw_r, alpha_r, alpha_rm, dalpha_r = res_ad
        base = residual_reduce(
            (alpha_rm * dalpha_r - alpha_r * c_pad.index_select(0, res[2]))
            * _dleaky(raw_r, slope), res, n8d, "sum")
    der_rank = prefix_reduce(pieces, n8d, base=base)
    der = _unranked(der_rank, plan.unrank_dst, plan.num_dst).to(er.dtype)

    # source space: dh[s] and del[s] over the reverse shells; everything
    # from the destination side packed into one gathered row
    # [er | mx | s | c | dz.flat] (4H + H*O)
    def node(x):
        return _unranked(x, plan.unrank_dst, plan.num_dst).to(gd)

    packed_rev = torch.cat([er.to(gd), node(mx), node(s), node(c),
                            dz.reshape(dz.shape[0], -1).to(gd)], dim=1)
    el_rank = _pad_rows(_ranked(el.to(torch.float32), plan.rank_src), n8s)
    h_rank = _pad_rows(_ranked(h.to(gd), plan.rank_src), n8s)

    def rev_rows(nidx, eidx, maskf, el_pre, h_pre):
        pk = packed_rev.index_select(0, nidx)
        er_g = pk[:, :H].to(torch.float32)
        mx_g = pk[:, H:2 * H].to(torch.float32)
        s_g = pk[:, 2 * H:3 * H].to(torch.float32)
        c_g = pk[:, 3 * H:4 * H].to(torch.float32)
        dz_g = pk[:, 4 * H:].reshape((pk.shape[0],) + tuple(HO))
        raw = el_pre + er_g
        alpha = torch.where(
            maskf > 0,
            torch.exp(_leaky(raw, slope) - mx_g) / torch.clamp(s_g,
                                                               min=1e-38),
            0.0)
        alpha_m = drop(alpha, eidx)
        dalpha = _head_dot(dz_g, h_pre, gd)
        dlogit = (alpha_m * dalpha - alpha * c_g) * _dleaky(raw, slope)
        dh_rows = (alpha_m.to(gd)[..., None] * dz_g).to(torch.float32)
        return dlogit, dh_rows

    pieces_del, pieces_dh = [], []
    for nidx, eidx, mask in plan.rev_shells:
        m = nidx.shape[0]
        dlogit, dh_rows = rev_rows(nidx, eidx, mask, el_rank[:m], h_rank[:m])
        pieces_del.append(dlogit)
        pieces_dh.append(dh_rows)
    base_del = base_dh = None
    rres = plan.res_src
    if _has_residual(rres):
        r_pos = rres[2]
        dlogit_r, dh_r = rev_rows(rres[0], rres[1], rres[4],
                                  el_rank.index_select(0, r_pos),
                                  h_rank.index_select(0, r_pos))
        base_del = residual_reduce(dlogit_r, rres, n8s, "sum")
        base_dh = residual_reduce(dh_r, rres, n8s, "sum")
    del_rank = prefix_reduce(pieces_del, n8s, base=base_del)
    dh_rank = prefix_reduce(pieces_dh, n8s, base=base_dh)
    del_ = _unranked(del_rank, plan.unrank_src, plan.num_src).to(el.dtype)
    dh = _unranked(dh_rank, plan.unrank_src, plan.num_src).to(h.dtype)
    return del_, der, dh


class _FusedGAT(torch.autograd.Function):
    @staticmethod
    def forward(ctx, slope, plan, el, er, h, drop_mask):
        out, mx, s = _fwd_impl(slope, plan, el, er, h, drop_mask)
        ctx.slope, ctx.plan = slope, plan
        ctx.save_for_backward(el, er, h, mx, s, drop_mask)
        return out

    @staticmethod
    def backward(ctx, dz):
        el, er, h, mx, s, drop_mask = ctx.saved_tensors
        if mx is None:  # the graph has no edge
            return (None, None, torch.zeros_like(el), torch.zeros_like(er),
                    torch.zeros_like(h), None)
        del_, der, dh = _fused_bwd(ctx.slope, ctx.plan, el, er, h, mx, s,
                                   drop_mask, dz)
        return None, None, del_, der, dh, None


def fused_gat_attention(slope, plan: ShellSpMMPlan, el, er, h,
                        drop_mask=None):
    """``out[d] = sum_s softmax_{s in N(d)}(leaky_relu(el[s] + er[d])) h[s]``.

    ``el`` (N_src, H), ``er`` (N_dst, H), ``h`` (N_src, H, O) -> (N_dst, H,
    O). Matches g-SDDMM + edge softmax + ``u_mul_e_sum`` to f32 accuracy
    with a ``gather_dtype="f32"`` plan (bf16-class with the default).
    ``drop_mask``: optional (E, H) multiplier in eid order on the
    normalised attention, typically ``bernoulli(keep) / keep``; it gets no
    gradient.
    """
    return _FusedGAT.apply(slope, plan, el, er, h, drop_mask)
