"""Dense-hub g-SpMM (counterpart of ``dgl_tpu/ops/hub_spmm.py``).

Split the sources into hubs (the top-H by out-degree) and the cold tail.
Hub edges aggregate as one dense matmul::

    out_hub = A_hub @ x[hub_ids]          # (N_dst, H) @ (H, F)

where ``A_hub[d, h]`` counts the edges ``hub_ids[h] -> d``.

Precision of the hub matmul: ``"int8"`` stores ``A_hub`` as int8 counts and
converts them to bf16 per call (falls back to bf16 storage if an edge
multiplicity exceeds 127); ``"bf16"`` stores bf16. The result is f32 in
both: on the card ``torch.mm`` with ``out_dtype=torch.float32`` on bf16
operands, on the CPU an f32 matmul of the same bf16-rounded operands.
``"f32"`` stores f32 counts and multiplies f32 rows in full f32, never at
TF32 whatever the process's setting (``_precision.full_f32``; the reference
pins ``Precision.HIGHEST``).

The cold tail (``cold``), as the reference's:

- ``"shell"`` (the default of int8 and bf16): the shell decomposition
  (``shell_spmm._build_dir``) through the shell prefix-sum kernel
  (``ops/shell_prefix.py``), which gathers the bf16-rounded rows and sums
  them in f32;
- ``"shell-f32"``: the same shells over the f32 rows (the kernel's f32
  instantiation);
- ``"f32"`` (the default of f32): a segment sum of the f32 rows over the
  cold edges in CSC order (``cold_src``, ``cold_dst``);
- ``"bf16"``: the same segment sum of rows rounded to bf16.

The segment sums run ``torch.segment_reduce`` over each destination's run
of the sorted cold edges (lengths counted at plan build; the padded
entries lie past the runs and drop): no atomics, so the exact modes give
the same bits run to run. The reference leaves these sums to XLA.

The backward is the same split transposed (reference ``_bwd``):
``A_hub^T @ dz`` for the hub sources, and for the others the reverse
shells (the cold edges ranked by source) through the same kernel, or the
segment sum over the cold edges sorted by source (``rev_src``,
``rev_dst``), added together with ``index_add_``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..base import DGLError
from ._precision import full_f32
from .shell_prefix import flat_shell_indices, level_table, shell_prefix_sum
from .shell_spmm import _build_dir, _rup, residual_reduce

__all__ = ["HubSpMMPlan", "build_hub_plan", "hub_copy_u_sum"]

_LANE = 128  # hub table padded to a multiple (the reference's MXU lane)

_DTYPES = {"int8": torch.int8, "bf16": torch.bfloat16, "f32": torch.float32}
_COLD = ("shell", "shell-f32", "bf16", "f32")


class HubSpMMPlan:
    """Precomputed hub/cold split of one relation, both directions.

    Tensors: ``hub_ids (H,)``, ``a_hub (N_dst, H)``; the cold edges in CSC
    order (``cold_src``, ``cold_dst``: sorted by destination, padded to a
    multiple of 8 with source 0 and destination ``num_dst``) and sorted by
    source for the backward (``rev_src``, ``rev_dst``: padded with
    ``num_src`` and 0), and each destination's and source's count of them
    (``cold_len``, ``rev_len``), in every mode, as the reference builds
    them. With ``cold`` in ``("shell", "shell-f32")``, for the forward,
    ``shells`` (per level ``(idx, mask)``, padded slots hold ``num_src``),
    ``res_dst`` (the beyond-cap residual ``(idx, pos_full, block_pos,
    mask)`` or None), ``unrank_dst`` (None when the graph is rank-ordered)
    and the kernel's layout of the shells: ``shell_idx`` (flat int32),
    ``shell_rows`` (the level sizes) and ``shell_levels`` (their (2, K)
    offset/size table). The backward's reverse shells (cold edges ranked by
    source, padded slots hold ``num_dst``) carry the same fields with a
    ``rev_`` prefix, and ``res_src``, ``unrank_src``. Without shells these
    are empty or None.
    """

    TENSOR_FIELDS = ("hub_ids", "a_hub", "cold_src", "cold_dst", "rev_src",
                     "rev_dst", "cold_len", "rev_len", "unrank_dst",
                     "shell_idx", "shell_levels", "unrank_src",
                     "rev_shell_idx", "rev_shell_levels")

    def __init__(self, hub_ids, a_hub, cold_src, cold_dst, rev_src, rev_dst,
                 shells=(), res_dst=None, unrank_dst=None, rev_shells=(),
                 res_src=None, unrank_src=None, *,
                 num_src: int, num_dst: int, num_hubs: int, coverage: float,
                 precision: str, cold: str = "f32"):
        self.hub_ids = hub_ids
        self.a_hub = a_hub
        self.cold_src = cold_src
        self.cold_dst = cold_dst
        self.rev_src = rev_src
        self.rev_dst = rev_dst
        self.shells = shells
        self.res_dst = res_dst
        self.unrank_dst = unrank_dst
        self.rev_shells = rev_shells
        self.res_src = res_src
        self.unrank_src = unrank_src
        self.num_src = int(num_src)
        self.num_dst = int(num_dst)
        self.num_hubs = int(num_hubs)
        self.coverage = float(coverage)
        self.precision = str(precision)
        self.cold = str(cold)
        # the real cold edges: the padded entries lie past them
        n_cold = int((cold_dst < num_dst).sum())
        self.num_cold = n_cold
        self.cold_len = torch.bincount(cold_dst[:n_cold].long(),
                                       minlength=num_dst)
        self.rev_len = torch.bincount(rev_src[:n_cold].long(),
                                      minlength=num_src)
        self.shell_idx, self.shell_rows, self.shell_levels = _flat_layout(
            shells, self.num_src, hub_ids.device)
        (self.rev_shell_idx, self.rev_shell_rows,
         self.rev_shell_levels) = _flat_layout(rev_shells, self.num_dst,
                                               hub_ids.device)

    def to(self, device) -> "HubSpMMPlan":
        new = HubSpMMPlan.__new__(HubSpMMPlan)
        new.__dict__.update(self.__dict__)
        for f in self.TENSOR_FIELDS:
            t = getattr(self, f)
            setattr(new, f, None if t is None else t.to(device))
        for f in ("shells", "rev_shells"):
            setattr(new, f, tuple((i.to(device), m.to(device))
                                  for i, m in getattr(self, f)))
        for f in ("res_dst", "res_src"):
            t = getattr(self, f)
            setattr(new, f, None if t is None
                    else tuple(x.to(device) for x in t))
        return new

    def direction(self, reverse: bool):
        """``(flat_idx, level_rows, levels, residual, unrank, n_out)`` of the
        forward shells, or of the reverse ones."""
        if reverse:
            return (self.rev_shell_idx, self.rev_shell_rows,
                    self.rev_shell_levels, self.res_src, self.unrank_src,
                    self.num_src)
        return (self.shell_idx, self.shell_rows, self.shell_levels,
                self.res_dst, self.unrank_dst, self.num_dst)

    def __repr__(self):
        return (f"HubSpMMPlan(H={self.num_hubs}, "
                f"coverage={self.coverage:.3f}, precision={self.precision}, "
                f"cold={self.cold})")


def _flat_layout(shells, oob_index, device):
    """The kernel's layout of one direction's shells: flat int32 indices,
    level sizes and level table (None, [], None without shells)."""
    if not shells:
        return None, [], None
    flat, rows = flat_shell_indices([idx for idx, _mask in shells], None,
                                    oob_index=oob_index)
    return flat, rows, level_table(rows, device)


def _build_shells(e_from, e_to, n_to, n_from, device):
    """Shell decomposition of the cold edges (host-side): returns (shells,
    residual, unrank) with shells a tuple of (idx_k, mask_k)."""
    shells3, res3, unrank, _rank = _build_dir(
        e_from, e_to, np.zeros_like(e_from), n_to, n_from=n_from,
        device=device)
    shells = tuple((nidx, mask) for nidx, _eidx, mask in shells3)
    res = None if res3 is None else (res3[0], res3[2], res3[3], res3[4])
    return shells, res, unrank


def build_hub_plan(rel, num_hubs: int = 2048, precision: str = "bf16",
                   cold: str | None = None, hub_ids_override=None):
    """Build a :class:`HubSpMMPlan` for a relation (host pass, once per
    graph). ``A_hub`` is built on the relation's device with one
    ``index_put_(..., accumulate=True)``. ``cold`` defaults to ``"f32"``
    for ``precision="f32"`` and to ``"shell"`` otherwise; shells are built
    only for the two shell modes."""
    if precision not in _DTYPES:
        raise DGLError(
            f"hub plan precision must be int8|bf16|f32, got {precision}")
    if cold is None:
        cold = "f32" if precision == "f32" else "shell"
    if cold not in _COLD:
        raise DGLError(
            f"hub plan cold must be shell|shell-f32|bf16|f32, got {cold}")
    device = rel.device
    src_csc, dst_csc = rel.host_arrays("csc_indices", "csc_dst")
    n_src, n_dst = rel.num_src, rel.num_dst
    real = (dst_csc < n_dst) & (src_csc < n_src)
    deg = np.bincount(src_csc[real], minlength=n_src)
    H = _rup(min(num_hubs, n_src), _LANE)
    n_top = min(num_hubs, n_src)
    if hub_ids_override is not None:
        top = np.asarray(hub_ids_override, np.int64)[:n_top]
    else:
        top = np.argsort(-deg, kind="stable")[:n_top]
    hub_ids = np.zeros(H, np.int32)
    hub_ids[:n_top] = top
    # +1 slot: padding edges carry src == n_src
    slot_of = np.full(n_src + 1, -1, np.int32)
    slot_of[top] = np.arange(n_top, dtype=np.int32)
    slots = np.where(real, slot_of[np.minimum(src_csc, n_src)], np.int32(-1))
    is_hub = slots >= 0
    hub_pos = np.nonzero(is_hub)[0]
    cold_idx = np.nonzero(real & ~is_hub)[0]
    n_cold = cold_idx.shape[0]
    Ec = _rup(n_cold, 8) if n_cold else 8

    def padded(vals, fill):
        out = torch.full((Ec,), fill, dtype=torch.int32, device=device)
        out[:n_cold] = vals
        return out

    # the cold edges in CSC order, and for the backward the same edges
    # sorted by source: one stable sort on the relation's device (the
    # reference's stable argsort, which takes seconds on the host at
    # Reddit's 114M cold edges)
    cs = torch.from_numpy(src_csc[cold_idx].astype(np.int32)).to(device)
    cd = torch.from_numpy(dst_csc[cold_idx].astype(np.int32)).to(device)
    order = torch.sort(cs, stable=True).indices
    cold_src, cold_dst = padded(cs, 0), padded(cd, n_dst)
    rev_src, rev_dst = padded(cs[order], n_src), padded(cd[order], 0)
    del cs, cd, order

    if precision == "int8" and hub_pos.size:
        # int8 holds multiplicities up to 127 exactly
        pair = dst_csc[hub_pos].astype(np.int64) * H + slots[hub_pos]
        if np.unique(pair, return_counts=True)[1].max() > 127:
            precision = "bf16"
    dtype = _DTYPES[precision]
    dst_h = torch.from_numpy(dst_csc[hub_pos].astype(np.int64)).to(device)
    slot_h = torch.from_numpy(slots[hub_pos].astype(np.int64)).to(device)
    a_hub = torch.zeros((n_dst, H), dtype=dtype, device=device)
    a_hub.index_put_((dst_h, slot_h),
                     torch.ones((), dtype=dtype, device=device),
                     accumulate=True)
    n_real = max(int(real.sum()), 1)
    if cold in ("shell", "shell-f32"):
        # padded shell slots point one past the table (n_from): the kernel
        # and the plain version read them as zero rows
        cs, cd = src_csc[cold_idx], dst_csc[cold_idx]
        shells, res_dst, unrank_dst = _build_shells(cs, cd, n_dst, n_src,
                                                    device)
        rev_shells, res_src, unrank_src = _build_shells(cd, cs, n_src, n_dst,
                                                        device)
    else:
        shells, res_dst, unrank_dst = (), None, None
        rev_shells, res_src, unrank_src = (), None, None

    return HubSpMMPlan(
        torch.from_numpy(hub_ids).to(device), a_hub, cold_src, cold_dst,
        rev_src, rev_dst, shells, res_dst, unrank_dst, rev_shells, res_src,
        unrank_src, num_src=n_src, num_dst=n_dst, num_hubs=H,
        coverage=float(is_hub.sum() / n_real), precision=precision,
        cold=cold)


def _mm(a, b, precision):
    """``a @ b`` with an f32 result: of bf16 operands for ``"int8"`` and
    ``"bf16"`` (int8 counts are exact in bf16), of f32 operands in full
    f32 for ``"f32"``."""
    if precision == "f32":
        with full_f32():
            return torch.mm(a.to(torch.float32), b.to(torch.float32))
    a = a.to(torch.bfloat16)
    b = b.to(torch.bfloat16)
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.to(torch.float32), b.to(torch.float32))


def _cold_gather(x, idx, cold):
    """The cold segment sum's rows: ``cold == "bf16"`` rounds them to bf16
    and back to f32 (the reference rounds the table before its gather: the
    same values)."""
    rows = x.index_select(0, idx)
    if cold == "bf16":
        return rows.to(torch.bfloat16).to(torch.float32)
    return rows


def _segment_sum(x, plan: HubSpMMPlan, reverse: bool = False):
    """The cold tail of the segment modes: ``out[d] = sum x[cold_src]``
    over each destination's run of ``cold_dst``, or (``reverse``)
    ``out[s] = sum x[rev_dst]`` over each source's run of ``rev_src``.
    Only the ``num_cold`` real edges are gathered."""
    n = plan.num_cold
    idx = (plan.rev_dst if reverse else plan.cold_src)[:n]
    lengths = plan.rev_len if reverse else plan.cold_len
    rows = _cold_gather(x, idx, plan.cold)
    return torch.segment_reduce(rows, "sum", lengths=lengths, axis=0,
                                unsafe=True)


def _residual_base(xg, plan: HubSpMMPlan, reverse: bool = False):
    """The beyond-cap residual's (rup(n_out, 8), F) f32 sums of the table
    ``xg`` (bf16, or f32 under ``cold="shell-f32"``), or None when the
    direction has no residual."""
    *_, res, _unrank, n_out = plan.direction(reverse)
    if res is None or int(res[1].shape[0]) == 0:
        return None
    r_idx, pos, bpos, r_mask = res
    rows = xg.index_select(0, r_idx).to(torch.float32) * r_mask
    return residual_reduce(rows, (None, None, pos, bpos, r_mask),
                           _rup(n_out, 8))


def _shell_sum(x, plan: HubSpMMPlan, reverse: bool = False):
    """``out[v] = sum_k x[idx_k[unrank[v]]]``: the shell modes' cold tail,
    over the forward shells or (``reverse``) the backward's.

    Under ``cold="shell"`` the rows are rounded to bf16 before the gather,
    as the reference does; under ``"shell-f32"`` the table goes to the
    kernel as it is. The beyond-cap residual reduces first, from the same
    table, and enters the kernel as its base."""
    flat_idx, rows, levels, _res, unrank, n_out = plan.direction(reverse)
    xg = x.to(torch.bfloat16) if plan.cold == "shell" else x
    base = _residual_base(xg, plan, reverse)
    if rows:
        acc = shell_prefix_sum(xg, flat_idx, rows, n_out, base=base,
                               levels=levels)
    elif base is not None:
        acc = base[:n_out]
    else:
        acc = x.new_zeros((n_out, x.shape[1]), dtype=torch.float32)
    return acc if unrank is None else acc[unrank.long()]


def _cold_sum(x, plan: HubSpMMPlan, reverse: bool = False):
    if plan.cold in ("shell", "shell-f32"):
        return _shell_sum(x, plan, reverse)
    return _segment_sum(x, plan, reverse)


def _hub_copy_u_sum2d(plan: HubSpMMPlan, x):
    out_hub = _mm(plan.a_hub, x.index_select(0, plan.hub_ids),
                  plan.precision)
    out_cold = _cold_sum(x, plan)
    return (out_hub + out_cold).to(x.dtype)


class _HubCopyUSum(torch.autograd.Function):
    """The hub SpMM; its backward is the same split transposed."""

    @staticmethod
    def forward(ctx, x, plan):
        ctx.plan = plan
        return _hub_copy_u_sum2d(plan, x)

    @staticmethod
    def backward(ctx, dz):
        plan = ctx.plan
        d_hub = _mm(plan.a_hub.t(), dz, plan.precision)
        dx = _cold_sum(dz, plan, reverse=True).to(d_hub.dtype)
        # hub and cold sources are disjoint; the hub table's padding slots
        # (id 0, zero columns of a_hub) add zero rows onto node 0
        dx.index_add_(0, plan.hub_ids.long(), d_hub)
        return dx.to(dz.dtype), None


def hub_copy_u_sum(plan: HubSpMMPlan, x):
    """``out[d] = sum_{(s->d) in E} x[s]`` through the plan's hub/cold
    split. Matches ``ops.copy_u_sum`` to f32 rounding for
    ``precision="f32"`` with an f32 cold tail, to about 1e-3 relative where
    rows are rounded to bf16 (f32 sums). Accepts any feature rank >= 1."""
    shape = tuple(x.shape)
    x2 = x.reshape(shape[0], -1)
    out = _HubCopyUSum.apply(x2, plan)
    return out.reshape((plan.num_dst,) + shape[1:])
