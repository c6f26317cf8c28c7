"""Bitmap-flash GAT forward (counterpart of ``dgl_tpu/ops/bitmap_gat.py``).

Full-graph attention over a relation that carries a bitmap plan
(:mod:`dgl_tpu_torch.ops.bitmap_spmm`). The logits are rank 1,
``raw[d, s] = leaky(er[d] + el[s])``, masked by the adjacency bits; the
softmax over each dst row's in-neighbours weights the projected source
features ``h``. Nothing E- or N^2-sized is stored.

:func:`bitmap_gat_fwd` runs the hand-written CUDA kernel
(``dgl_tpu_torch/csrc/bitmap_gat_fwd.cu``: one warp per dst row walks its
set bits with an online softmax) on a CUDA tensor, and the plain PyTorch
version :func:`gat_fwd_plain` (the reference's ``_gat_xla``, chunked over
dst rows) on a CPU tensor. Both return ``out`` and ``lse`` as ``_gat_xla``
defines them: ``p`` in f32, ``h`` rounded to bf16, zero-in-degree rows with
``out = 0`` and ``lse = log(1e-30)``.

This slice ports the forward. The backward (kernels B4 and B5) is the
training slice; the autograd function keeps ``lse`` for it and raises.
"""
from __future__ import annotations

import torch

from .. import _kernels
from .bitmap_spmm import BitmapPlan, _expand_bits

__all__ = ["bitmap_gat", "bitmap_gat_fwd", "gat_fwd_plain", "BitmapPlan"]

_NEG = -1e30  # finite "-inf" of the reference's masked logits


def _leaky(x, slope):
    return torch.where(x > 0, x, x * slope)


def _pad_rows(x, n):
    if x.shape[0] == n:
        return x
    return torch.cat([x, x.new_zeros((n - x.shape[0],) + tuple(x.shape[1:]))])


def gat_fwd_plain(bits, el, er, h, slope, chunk=None):
    """Plain PyTorch version of the forward (reference ``_gat_xla``).

    ``bits``: (R, W) plane-packed rows; ``el`` (n_src, H) f32 with
    n_src <= 8 W; ``er`` (R, H) f32; ``h`` (n_src, H, O), taken as f32 of
    its values. Returns ``out`` (R, H, O) and ``lse`` (R, H), both f32.
    Works ``chunk`` dst rows at a time in (H, rows, n_src) layout (by
    default about 256 MB per f32 temporary)."""
    n_rows = bits.shape[0]
    n_src, heads = el.shape
    odim = h.shape[2]
    if chunk is None:
        chunk = max(1, (1 << 26) // max(heads * n_src, 1))
    elT = el.to(torch.float32).t().contiguous()            # (H, n_src)
    erT = er.to(torch.float32).t()                         # (H, R)
    hh = h.to(torch.float32).permute(1, 0, 2).contiguous()  # (H, n_src, O)
    out = torch.empty((n_rows, heads, odim), dtype=torch.float32,
                      device=el.device)
    lse = torch.empty((n_rows, heads), dtype=torch.float32, device=el.device)
    for c0 in range(0, n_rows, chunk):
        c1 = min(c0 + chunk, n_rows)
        mask = _expand_bits(bits[c0:c1])[:, :n_src].bool()  # (C, n_src)
        raw = _leaky(erT[:, c0:c1, None] + elT[:, None, :], slope)
        raw = raw.masked_fill(~mask, _NEG)                 # (H, C, n_src)
        m = raw.amax(dim=2)
        # zero-in-degree guard: shift an all-masked row by 0, so its
        # masked slots underflow to exact 0
        m_eff = torch.where(m > _NEG / 2, m, torch.zeros_like(m))
        p = torch.exp(raw - m_eff[:, :, None])
        s = p.sum(dim=2).clamp_min(1e-30)                  # (H, C)
        o = torch.bmm(p, hh) / s[:, :, None]               # (H, C, O)
        out[c0:c1] = o.permute(1, 0, 2)
        lse[c0:c1] = (m_eff + torch.log(s)).t()
    return out, lse


def bitmap_gat_fwd(bits, el, er, h, slope, n_rows=None):
    """``out`` (n_rows, H, O) and ``lse`` (n_rows, H), both f32, of the
    attention over the first ``n_rows`` bitmap rows. ``el`` (n_src, H)
    f32, ``er`` (>= n_rows, H) f32, ``h`` (n_src, H, O) bf16.

    A CUDA ``h`` runs the kernel; a CPU ``h`` runs the plain version."""
    n_rows = bits.shape[0] if n_rows is None else int(n_rows)
    if h.device.type == "cpu":
        return gat_fwd_plain(bits[:n_rows], el, er[:n_rows], h, slope)
    if not h.is_cuda:
        raise ValueError(f"bitmap_gat_fwd: unsupported device {h.device}")
    return _launch(bits, el, er, h, float(slope), n_rows)


def _pow2_at_least(n):
    p = 1
    while p < n:
        p *= 2
    return p


def _launch(bits, el, er, h, slope, n_rows):
    dev = h.device
    if bits.dtype != torch.uint8 or bits.dim() != 2 or bits.device != dev:
        raise ValueError("bits must be a 2-D uint8 bitmap on h's device")
    if h.dtype != torch.bfloat16 or h.dim() != 3:
        raise ValueError(f"h must be 3-D bf16, got {h.dtype} "
                         f"{tuple(h.shape)}")
    n_src, heads, odim = h.shape
    n_bits_rows, W = bits.shape
    if (el.dtype != torch.float32 or er.dtype != torch.float32
            or el.device != dev or er.device != dev
            or tuple(el.shape) != (n_src, heads) or er.dim() != 2
            or er.shape[1] != heads or er.shape[0] < n_rows):
        raise ValueError("el must be (n_src, H) and er (>= n_rows, H) f32 "
                         "on h's device")
    if W % 512 or n_rows > n_bits_rows or n_src > W * 8:
        raise ValueError(f"bitmap {tuple(bits.shape)} does not fit h "
                         f"{tuple(h.shape)} and n_rows={n_rows}")
    out = torch.empty((n_rows, heads, odim), dtype=torch.float32,
                      device=dev)
    lse = torch.empty((n_rows, heads), dtype=torch.float32, device=dev)
    if n_rows == 0 or heads == 0 or odim == 0:
        return out, lse
    # one pass holds nh heads x nf features of accumulator (nh * nf <= 64);
    # heads and features pad to whole passes and 16-byte row gathers
    nf = 8 if odim <= 8 else 16 if odim <= 16 else 32 if odim <= 32 else 64
    nh = min(64 // nf, _pow2_at_least(heads))
    h_pad, o_pad = -(-heads // nh) * nh, -(-odim // nf) * nf
    er = er[:n_rows]
    if h_pad != heads:
        el = torch.nn.functional.pad(el, (0, h_pad - heads))
        er = torch.nn.functional.pad(er, (0, h_pad - heads))
    if (h_pad, o_pad) != (heads, odim):
        h = torch.nn.functional.pad(h, (0, o_pad - odim, 0, h_pad - heads))
    el, er, h = el.contiguous(), er.contiguous(), h.contiguous()
    if h.data_ptr() % 16:
        h = h.clone()
    bits = bits.contiguous()
    lib = _kernels.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.dgl_bitmap_gat_fwd(
            bits.data_ptr(), n_rows, W, el.data_ptr(), er.data_ptr(),
            h.data_ptr(), n_src, heads, odim, h_pad, o_pad, nh, nf, slope,
            out.data_ptr(), lse.data_ptr(), stream)
    _kernels.check(code, "bitmap_gat_fwd")
    _kernels.launch_counts["bitmap_gat_fwd"] += 1
    return out, lse


def _prep(plan, el, er, h):
    """The reference's operand preparation: el and er in f32, h in bf16,
    el and h padded to the bitmap's column count, er to its row count."""
    Hp, W = plan.bits.shape
    Ws = W * 8
    nheads, odim = int(el.shape[1]), int(h.shape[2])
    elp = _pad_rows(el.to(torch.float32), Ws)
    erp = _pad_rows(er.to(torch.float32), Hp)
    hp = _pad_rows(h.to(torch.bfloat16).reshape(h.shape[0], -1), Ws)
    return elp, erp, hp.reshape(Ws, nheads, odim)


class _BitmapGAT(torch.autograd.Function):
    """Forward of bitmap-flash GAT; its backward is the training slice."""

    @staticmethod
    def forward(ctx, el, er, h, slope, plan):
        elp, erp, hp = _prep(plan, el, er, h)
        out, lse = bitmap_gat_fwd(plan.bits, elp, erp, hp, slope,
                                  plan.num_dst)
        ctx.save_for_backward(el, er, h, lse)  # for kernels B4 and B5
        return out.to(h.dtype)

    @staticmethod
    def backward(ctx, dz):
        raise NotImplementedError(
            "bitmap GAT backward (kernels B4 and B5): the training slice, "
            "ROADMAP queue B4/B5")


def bitmap_gat(slope, plan: BitmapPlan, el, er, h):
    """Full-graph GAT aggregation over a bitmap plan.

    ``el`` (num_src, H): per-source logit halves; ``er`` (num_dst, H):
    per-destination halves; ``h`` (num_src, H, O): projected features.
    Returns (num_dst, H, O) in ``h.dtype``: ``sum_s alpha[s, d] h[s]`` with
    alpha the softmax of ``leaky(el[s] + er[d])`` over each destination's
    in-neighbours."""
    return _BitmapGAT.apply(el, er, h, slope, plan)
