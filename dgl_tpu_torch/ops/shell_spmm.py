"""Shell-decomposition g-SpMM (counterpart of
``dgl_tpu/ops/shell_spmm.py``).

Rank destinations by in-degree; the destinations with more than ``k``
in-edges then form a prefix of the rank order, so "the k-th in-edge of
every destination" is one flat gather added into a prefix: no scatter.
Levels at and beyond ``SHELL_CAP`` go to a block-padded residual reduced
by :func:`residual_reduce`. The gradient for the source table runs the
same structure transposed (sources ranked by out-degree, the reverse
shells); the gradient for the edge values is pure gathers.

The builder, the residual and prefix reductions (sum and max), the
weighted plan (:class:`ShellSpMMPlan`, :func:`build_shell_plan`, attached
by ``Graph.with_spmm_plans(weighted=True)``), :func:`shell_gspmm_sum` (every
binary op with the sum reducer, a hand backward), :func:`shell_gspmm_cmp`
(max/min), and the rank-space edge reductions of the edge softmax
(:func:`shell_edge_acc`, :func:`shell_edge_softmax`).

The levels of :func:`shell_gspmm_sum` go through the hand-written kernel
``shell_prefix_gspmm`` (``ops/shell_prefix.py``), which builds each message
and sums it in one pass; the TPU builds the message stream with XLA ops and
hands it to its Pallas prefix-sum kernel. The residual's messages are
built with PyTorch ops and reduce first, into the kernel's base, as the
reference's do.

Rounding follows the reference: with ``gather_dtype="bf16"`` the node and
edge tables are rounded to bf16 and each message is computed in bf16 (so
rounded once more) before the f32 sums; the edge-value gradient takes the
f32 cotangent and the f32 tables.
"""
from __future__ import annotations

import numpy as np
import torch

from ..base import DGLError
from .spmm import _expand, _reduce_grad

__all__ = ["SHELL_CAP", "RES_BLOCK", "ShellSpMMPlan", "build_shell_plan",
           "residual_reduce", "prefix_reduce", "shell_gspmm_sum",
           "shell_gspmm_cmp", "shell_edge_acc", "shell_edge_softmax"]

SHELL_CAP = 32  # max shell levels; deeper edges take the blocked residual
RES_BLOCK = 32  # residual rows per reduce block (see residual_reduce)


def _rup(x: int, m: int) -> int:
    return max(int(-(-x // m) * m), m)


def residual_reduce(rows, residual, n8, kind="sum"):
    """Reduce residual rows into the ranked accumulator.

    ``rows`` (R', *feat) already hold the identity (0 for ``"sum"``, -inf
    for ``"max"``) in padded slots. Each rank position's run is padded to a
    multiple of RES_BLOCK at plan build, so the reduction is a reshape
    over blocks followed by one sorted segment reduction over the block
    partials. Rows no block reaches hold the identity."""
    block_pos = residual[3].to(torch.int64)
    nb = block_pos.shape[0]
    feat = tuple(rows.shape[1:])
    r = rows.reshape((nb, RES_BLOCK) + feat)
    if kind == "sum":
        return rows.new_zeros((n8,) + feat).index_add(0, block_pos, r.sum(1))
    part = r.amax(1)
    idx = block_pos.reshape((nb,) + (1,) * len(feat)).expand_as(part)
    return rows.new_full((n8,) + feat, -torch.inf).scatter_reduce(
        0, idx, part, "amax", include_self=True)


def prefix_reduce(pieces, n8, base=None, kind="sum"):
    """Combine prefix-aligned contributions.

    ``pieces``: (m_k, *feat) tensors with non-increasing m_k, each reduced
    into ``out[:m_k]``; ``base``: optional full (n8, *feat) tensor. Rows no
    piece covers hold the identity (0 for ``"sum"``, -inf for ``"max"``).
    The running reduction is f32 whatever the pieces' type; it shrinks with
    the prefix and the finished tail segments are concatenated once at the
    end, base first and then level by level. Returns None when there is
    neither a piece nor a base."""
    ident = 0.0 if kind == "sum" else -torch.inf
    comb = torch.add if kind == "sum" else torch.maximum
    segs = []
    R = base
    for rows in pieces:
        m = rows.shape[0]
        if R is None:
            if m < n8:
                segs.append(torch.full((n8 - m,) + tuple(rows.shape[1:]),
                                       ident, dtype=torch.float32,
                                       device=rows.device))
            R = rows.to(torch.float32)
        elif m < R.shape[0]:
            segs.append(R[m:])
            R = comb(R[:m], rows.to(torch.float32))
        else:
            R = comb(R, rows.to(torch.float32))
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


# ---------------------------------------------------------------------------
# the weighted plan
# ---------------------------------------------------------------------------


class _Direction:
    """One direction's shells in the kernel's layout (built on the host at
    plan build): flat int32 node and edge indices (each level padded to
    ``shell_prefix.BLOCK_ROWS`` with index 0), each level's padded length
    ``level_rows`` (the reference's ``n_k8``) and real row count
    ``level_real`` (``n_k``, the ones of its mask), and the (2, K) int64
    table of level offsets and real counts the kernel reads."""

    __slots__ = ("nidx", "eidx", "level_rows", "level_real", "levels")

    def __init__(self, nidx, eidx, level_rows, level_real, levels):
        self.nidx = nidx
        self.eidx = eidx
        self.level_rows = level_rows
        self.level_real = level_real
        self.levels = levels

    @staticmethod
    def build(shells):
        """The layout of CPU-built shells, on the CPU."""
        from .shell_prefix import flat_shell_indices, level_table

        if not shells:
            return _Direction(None, None, [], [], None)
        nidx, rows = flat_shell_indices([s[0] for s in shells], None,
                                        oob_index=0)
        eidx, _ = flat_shell_indices([s[1] for s in shells], None,
                                     oob_index=0)
        real = [int(s[2].sum()) for s in shells]
        return _Direction(nidx, eidx, rows, real,
                          level_table(rows, "cpu", counts=real))

    def to(self, device) -> "_Direction":
        return _Direction(*(None if t is None else t.to(device)
                            for t in (self.nidx, self.eidx)),
                          self.level_rows, self.level_real,
                          None if self.levels is None
                          else self.levels.to(device))


class ShellSpMMPlan:
    """Full-edge shell decomposition of one relation, both directions.

    The arrays of the reference's plan (``ARRAY_FIELDS``, equal to them):
    ``shells``/``rev_shells`` (per level ``(nidx, eidx, mask)``, padded
    slots gather row 0 and edge 0), ``res_dst``/``res_src`` (the beyond-cap
    residual ``(nidx, eidx, pos_full, block_pos, mask)`` or None),
    ``unrank_dst``/``unrank_src`` and ``rank_dst``/``rank_src`` (None when
    the rank order is the identity), the eid-order endpoints ``src_eid``,
    ``dst_eid`` (padded edges clamped to 0) and ``emask``, and each edge's
    endpoint rank positions ``dst_rank_eid``/``src_rank_eid``. Beside them,
    each direction's kernel layout (:class:`_Direction`: ``fwd`` over the
    shells, ``rev`` over the reverse shells).
    """

    ARRAY_FIELDS = ("shells", "res_dst", "unrank_dst",
                    "rev_shells", "res_src", "unrank_src",
                    "src_eid", "dst_eid", "emask",
                    "dst_rank_eid", "src_rank_eid",
                    "rank_dst", "rank_src")

    def __init__(self, shells, res_dst, unrank_dst, rev_shells, res_src,
                 unrank_src, src_eid, dst_eid, emask, dst_rank_eid,
                 src_rank_eid, rank_dst=None, rank_src=None, *,
                 num_src: int, num_dst: int, gather_dtype: str = "bf16",
                 fwd: _Direction, rev: _Direction):
        self.shells = shells
        self.res_dst = res_dst
        self.unrank_dst = unrank_dst
        self.rev_shells = rev_shells
        self.res_src = res_src
        self.unrank_src = unrank_src
        self.src_eid = src_eid
        self.dst_eid = dst_eid
        self.emask = emask
        self.dst_rank_eid = dst_rank_eid
        self.src_rank_eid = src_rank_eid
        self.rank_dst = rank_dst
        self.rank_src = rank_src
        self.num_src = int(num_src)
        self.num_dst = int(num_dst)
        self.gather_dtype = str(gather_dtype)
        self.fwd = fwd
        self.rev = rev

    def to(self, device) -> "ShellSpMMPlan":
        def move(x):
            if x is None:
                return None
            if isinstance(x, tuple):
                return tuple(move(t) for t in x)
            return x.to(device)

        new = ShellSpMMPlan.__new__(ShellSpMMPlan)
        new.__dict__.update(self.__dict__)
        for f in self.ARRAY_FIELDS:
            setattr(new, f, move(getattr(self, f)))
        new.fwd, new.rev = self.fwd.to(device), self.rev.to(device)
        return new

    def direction(self, reverse: bool):
        """``(layout, residual, unrank, n_out)`` of the forward shells or,
        with ``reverse``, of the reverse ones."""
        if reverse:
            return self.rev, self.res_src, self.unrank_src, self.num_src
        return self.fwd, self.res_dst, self.unrank_dst, self.num_dst

    def __repr__(self):
        return (f"ShellSpMMPlan(shells={len(self.shells)}, "
                f"rev={len(self.rev_shells)}, gather={self.gather_dtype})")


def build_shell_plan(rel, gather_dtype: str = "bf16") -> ShellSpMMPlan:
    """Build the full-edge shell plan (on the host, once per graph) and
    move it to the relation's device.

    ``gather_dtype="bf16"`` rounds the gathered tables and messages to
    bfloat16 (f32 sums, about 1e-3 relative error); ``"f32"`` keeps
    everything exact."""
    if gather_dtype not in ("bf16", "f32"):
        raise DGLError(f"gather_dtype must be bf16|f32, got {gather_dtype}")
    src, dst, eid, se, de_ = rel.host_arrays(
        "csc_indices", "csc_dst", "csc_eids", "src", "dst")
    real = (dst < rel.num_dst) & (src < rel.num_src)
    src, dst, eid = src[real], dst[real], eid[real]
    shells, res_dst, unrank_dst, rank_dst = _build_dir(
        src, dst, eid, rel.num_dst)
    rev_shells, res_src, unrank_src, rank_src = _build_dir(
        dst, src, eid, rel.num_src)
    # eid-order endpoints for the edge-value gradient (clamped so padded
    # slots gather row 0 and are zeroed by emask)
    se, de_ = se.astype(np.int64), de_.astype(np.int64)
    ok = (se < rel.num_src) & (de_ < rel.num_dst)
    emask = ok.astype(np.float32)
    se_c = np.where(ok, se, 0).astype(np.int32)
    de_c = np.where(ok, de_, 0).astype(np.int32)
    dst_rank = de_c if unrank_dst is None else unrank_dst.numpy()[de_c]
    src_rank = se_c if unrank_src is None else unrank_src.numpy()[se_c]
    arrays = [torch.from_numpy(np.ascontiguousarray(a))
              for a in (se_c, de_c, emask, dst_rank, src_rank)]
    plan = ShellSpMMPlan(
        shells, res_dst, unrank_dst, rev_shells, res_src, unrank_src,
        *arrays, rank_dst, rank_src, num_src=rel.num_src,
        num_dst=rel.num_dst, gather_dtype=gather_dtype,
        fwd=_Direction.build(shells), rev=_Direction.build(rev_shells))
    return plan.to(rel.device)


# ---------------------------------------------------------------------------
# g-SpMM with the sum reducer
# ---------------------------------------------------------------------------


def _mask_expand(mask, ndim):
    """Shape a (n, 1) (or (n,)) mask to exactly ``ndim`` dims."""
    return mask.reshape((mask.shape[0],) + (1,) * (ndim - 1))


def _g(x, gather_dtype):
    return x.to(torch.bfloat16) if gather_dtype == "bf16" else x


def _rounded(x, gather_dtype):
    """``x`` rounded to the gather dtype but kept in its own type, with
    the identity's gradient: the values of ``_g(x).to(x.dtype)``, whose
    backward (through ``index_select``, a scatter-add) sums in ``x``'s
    type, not in bf16."""
    if gather_dtype != "bf16":
        return x
    return x + (x.to(torch.bfloat16).to(x.dtype) - x).detach()


def _msg(op, ul, el):
    """The message of gathered rows (the reference's ``_msg``): computed in
    the operands' type, so bf16 operands give a bf16-rounded message."""
    if op == "copy_lhs":
        return ul
    if op == "copy_rhs":
        return el
    if ul.dim() != el.dim():
        nd = max(ul.dim(), el.dim())
        ul, el = _expand(ul, nd), _expand(el, nd)
    if op == "add":
        return ul + el
    if op == "sub":
        return ul - el
    if op == "mul":
        return ul * el
    if op == "div":
        return ul / el
    raise DGLError(f"Unknown spmm binary op {op!r}")


def _has_residual(residual) -> bool:
    return residual is not None and int(residual[2].shape[0]) > 0


def _residual_base(op, lhs, rhs, residual, n_out):
    """The beyond-cap residual's (rup(n_out, 8), *feat) f32 sums of the
    messages, or None when the direction has no residual."""
    if not _has_residual(residual):
        return None
    r_nidx, r_eidx, _pos, _bpos, r_mask = residual
    ul = None if lhs is None else lhs.index_select(0, r_nidx)
    el = None if rhs is None else rhs.index_select(0, r_eidx)
    rows = _msg(op, ul, el).to(torch.float32)
    # where, not a product: padded slots may hold inf or NaN (a division
    # by a zero edge value gathered from edge 0)
    rows = torch.where(_mask_expand(r_mask, rows.dim()) > 0, rows, 0.0)
    return residual_reduce(rows, residual, _rup(n_out, 8))


def _shell_accumulate(plan, reverse, op, lhs, rhs):
    """``out[v] = sum_k msg(shell_k)[unrank[v]]`` over one direction, in
    f32; None when the direction has no edge. The residual reduces first
    and enters the kernel as its base; the kernel stores each rank row at
    its node (``rank``), so no unrank gather follows it."""
    from .shell_prefix import shell_prefix_gspmm

    lay, residual, unrank, n_out = plan.direction(reverse)
    base = _residual_base(op, lhs, rhs, residual, n_out)
    if lay.level_rows:
        return shell_prefix_gspmm(
            op, lhs, rhs, lay.nidx, lay.eidx, lay.level_rows,
            lay.level_real, n_out, base=base, levels=lay.levels,
            rank=plan.rank_src if reverse else plan.rank_dst)
    if base is None:
        return None
    acc = base[:n_out]
    return acc if unrank is None else acc.index_select(0, unrank.long())


def _fwd_impl(op, plan, u, e):
    gd = plan.gather_dtype
    ub = _g(u, gd) if u is not None and op != "copy_rhs" else None
    eb = _g(e, gd) if e is not None and op != "copy_lhs" else None
    ref = u if op != "copy_rhs" else e
    out = _shell_accumulate(plan, False, op, ub, eb)
    if out is None:
        feat = _out_feat(op, ub, eb)
        return ref.new_zeros((plan.num_dst,) + feat)
    return out.to(ref.dtype)


def _out_feat(op, lhs, rhs):
    """The message's feature shape (right-aligned broadcast, as ``_msg``)."""
    if op == "copy_lhs":
        return tuple(lhs.shape[1:])
    if op == "copy_rhs":
        return tuple(rhs.shape[1:])
    fl, fr = tuple(lhs.shape[1:]), tuple(rhs.shape[1:])
    nd = max(len(fl), len(fr))
    fl, fr = fl + (1,) * (nd - len(fl)), fr + (1,) * (nd - len(fr))
    return tuple(torch.broadcast_shapes(fl, fr))


class _ShellGSpMMSum(torch.autograd.Function):
    """The shell g-SpMM with the reference's hand backward (``_shell_bwd``):
    the source gradient over the reverse shells through the kernel, with
    the cotangent rounded to the gather dtype; the edge gradient as pure
    gathers in eid order from the f32 cotangent and tables."""

    @staticmethod
    def forward(ctx, op, plan, u, e):
        ctx.op, ctx.plan = op, plan
        ctx.save_for_backward(u, e)
        return _fwd_impl(op, plan, u, e)

    @staticmethod
    def backward(ctx, dz):
        op, plan = ctx.op, ctx.plan
        u, e = ctx.saved_tensors
        gd = plan.gather_dtype
        du = de = None
        if op != "copy_rhs" and u is not None and ctx.needs_input_grad[2]:
            # dU[s] = sum over out-edges of dZ[dst] (op' e): reverse shells
            dzb = _g(dz, gd)
            if op in ("copy_lhs", "add", "sub"):
                mop, rhs = "copy_lhs", None
            elif op in ("mul", "div"):
                mop, rhs = op, _g(e, gd)
            else:
                raise DGLError(op)
            du = _shell_accumulate(plan, True, mop, dzb, rhs)
            if du is None:
                du = dz.new_zeros((plan.num_src,) + tuple(dz.shape[1:]),
                                  dtype=torch.float32)
            du = _reduce_grad(du, u.shape).to(u.dtype)
        if op != "copy_lhs" and e is not None and ctx.needs_input_grad[3]:
            # dE: pure gathers in eid order, the reference's rule
            # (``backend/pytorch/sparse.py:205-230``)
            dz_d = dz.index_select(0, plan.dst_eid)
            if op in ("copy_rhs", "add"):
                de = dz_d
            elif op == "sub":
                de = -dz_d
            elif op == "mul":
                de = dz_d * _expand(u.index_select(0, plan.src_eid),
                                    dz_d.dim())
            elif op == "div":
                eu = _expand(u.index_select(0, plan.src_eid), dz_d.dim())
                ee = _expand(e, dz_d.dim())
                de = -dz_d * eu / (ee * ee)
            else:
                raise DGLError(op)
            de = torch.where(_mask_expand(plan.emask, de.dim()) > 0, de, 0.0)
            de = _reduce_grad(de, e.shape).to(e.dtype)
        return None, None, du, de


def shell_gspmm_sum(op, plan: ShellSpMMPlan, u, e):
    """g-SpMM with the sum reducer through the shell decomposition; matches
    ``ops.gspmm(g, op, "sum", u, e)`` to about 1e-3 relative with bf16
    gathers and exactly (up to the order of f32 sums) with
    ``gather_dtype="f32"``. ``u`` (N_src, ...) and ``e`` (E, ...) broadcast
    like ``gspmm``'s operands; either is None for the copy ops."""
    return _ShellGSpMMSum.apply(op, plan, u, e)


# ---------------------------------------------------------------------------
# edge-value reductions in rank space (the edge softmax's building blocks)
# ---------------------------------------------------------------------------


def shell_edge_acc(shells, n_out, evals, kind="sum", transform=None,
                   residual=None):
    """Segment-reduce per-edge values keyed by the shells' ranked nodes.

    Returns the ranked accumulator ``(rup(n_out, 8), *feat)``: row i holds
    the reduction over the rank-i node's edges. ``transform(rows, pos)``
    optionally maps gathered rows given their rank positions (None for a
    capped level, whose rows are the prefix ``[0, n_k8)``; the residual's
    position array otherwise). ``kind`` in {"sum", "max"}; empty segments
    hold the identity (0 / -inf)."""
    n8 = _rup(n_out, 8)
    ident = 0.0 if kind == "sum" else -torch.inf
    base = None
    if _has_residual(residual):
        _, r_eidx, r_pos, _bpos, r_mask = residual
        rows = evals.index_select(0, r_eidx).to(torch.float32)
        if transform is not None:
            rows = transform(rows, r_pos)
        rows = torch.where(_mask_expand(r_mask, rows.dim()) > 0, rows, ident)
        base = residual_reduce(rows, residual, n8, kind)
    pieces = []
    for _nidx, eidx, mask in shells:
        rows = evals.index_select(0, eidx).to(torch.float32)
        if transform is not None:
            rows = transform(rows, None)
        pieces.append(torch.where(_mask_expand(mask, rows.dim()) > 0, rows,
                                  ident))
    acc = prefix_reduce(pieces, n8, base=base, kind=kind)
    if acc is None:
        return evals.new_zeros((n8,), dtype=torch.float32)
    return acc


def _softmax_side(plan: ShellSpMMPlan, norm_by: str):
    if norm_by == "dst":
        return plan.shells, plan.res_dst, plan.num_dst, plan.dst_rank_eid
    return plan.rev_shells, plan.res_src, plan.num_src, plan.src_rank_eid


def shell_edge_softmax(plan: ShellSpMMPlan, logits, norm_by="dst"):
    """Numerically stable edge softmax with no segment reduction: the max
    and the exp-sum accumulate over shell prefixes in rank space, and each
    edge reads them back with one gather through its precomposed rank
    position. Padded edges read node 0's aggregates (callers mask them)."""
    shells, res, n_out, rank_eid = _softmax_side(plan, norm_by)
    mx = shell_edge_acc(shells, n_out, logits, kind="max", residual=res)
    mx = torch.where(torch.isfinite(mx), mx, 0.0)
    mx_pad = torch.cat([mx, mx.new_zeros((1,) + tuple(mx.shape[1:]))])

    def shift_exp(rows, pos):
        m = mx[: rows.shape[0]] if pos is None else mx_pad.index_select(
            0, pos)
        return torch.exp(rows - _expand(m, rows.dim()))

    s = shell_edge_acc(shells, n_out, logits, kind="sum",
                       transform=shift_exp, residual=res)
    mx_e = mx.index_select(0, rank_eid)
    s_e = torch.clamp(s, min=1e-38).index_select(0, rank_eid)
    mx_e, s_e = _expand(mx_e, logits.dim()), _expand(s_e, logits.dim())
    return (torch.exp(logits - mx_e) / s_e).to(logits.dtype)


# ---------------------------------------------------------------------------
# g-SpMM with the max/min reducer
# ---------------------------------------------------------------------------


def shell_gspmm_cmp(op, reduce_op, plan: ShellSpMMPlan, u, e, in_degrees):
    """g-SpMM with the max/min reducer through the shells, differentiated
    by PyTorch's autograd (an arg-extremum rule; a tie splits its gradient
    evenly). Zero-in-degree rows give 0, as the plain path.

    The messages are the reference's, the operands and each message
    rounded to the gather dtype, but carried in f32 (``_rounded``), so the
    backward sums a node's gradient over its out-edges in f32, as the sum
    reducer's hand backward does; the reference's autograd sums it in
    bf16, which at a hub of thousands of out-edges drifts past the plan
    paths' bound."""
    gd = plan.gather_dtype
    ub = _rounded(u, gd) if u is not None and op != "copy_rhs" else None
    eb = _rounded(e, gd) if e is not None and op != "copy_lhs" else None
    sign = 1.0 if reduce_op == "max" else -1.0
    n8 = _rup(plan.num_dst, 8)

    def rows_of(nidx, eidx, mask):
        ul = None if ub is None else ub.index_select(0, nidx)
        el = None if eb is None else eb.index_select(0, eidx)
        rows = _rounded(_msg(op, ul, el), gd).to(torch.float32) * sign
        return torch.where(_mask_expand(mask, rows.dim()) > 0, rows,
                           -torch.inf)

    base = None
    res = plan.res_dst
    if _has_residual(res):
        base = residual_reduce(rows_of(res[0], res[1], res[4]), res, n8,
                               "max")
    pieces = [rows_of(*s) for s in plan.shells]
    acc = prefix_reduce(pieces, n8, base=base, kind="max")
    ref = u if op != "copy_rhs" else e
    if acc is None:
        return ref.new_zeros((plan.num_dst,) + _out_feat(op, ub, eb))
    accs = acc * sign
    out = (accs[: plan.num_dst] if plan.unrank_dst is None
           else accs.index_select(0, plan.unrank_dst.long()))
    deg = _mask_expand(in_degrees > 0, out.dim())
    return torch.where(deg, out, 0.0).to(ref.dtype)
