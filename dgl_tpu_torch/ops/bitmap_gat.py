"""Bitmap-flash GAT (counterpart of ``dgl_tpu/ops/bitmap_gat.py``).

Full-graph attention over a relation that carries a bitmap plan
(:mod:`dgl_tpu_torch.ops.bitmap_spmm`). The logits are rank 1,
``raw[d, s] = leaky(er[d] + el[s])``, masked by the adjacency bits; the
softmax over each dst row's in-neighbours weights the projected source
features ``h``. Nothing E- or N^2-sized is stored.

:func:`bitmap_gat_fwd` runs the hand-written CUDA kernel B3
(``dgl_tpu_torch/csrc/bitmap_gat_fwd.cu``: one warp per dst row walks the
row's in-edge list from the relation's CSC, ``csc_indptr`` /
``csc_indices``, with an online softmax and a chunk of gathers in flight) on
a CUDA tensor, and the plain PyTorch version :func:`gat_fwd_plain` (the
reference's ``_gat_xla`` over the plan's bits, chunked over dst rows) on a
CPU tensor. The plan refuses multi-edges, so the CSC and the bits name the
same (d, s) pairs. Both return ``out`` and ``lse`` as ``_gat_xla`` defines
them: ``p`` in f32, ``h`` rounded to bf16, zero-in-degree rows with
``out = 0`` and ``lse = log(1e-30)``.

The backward is the reference's flash decomposition, with ``alpha``
recomputed from ``lse``, ``B = alpha * leaky'(raw)`` and ``c[d] = out[d] .
dz[d]`` taken from the f32 ``dz``; both kernels then get ``dz`` rounded to
bf16, as the reference's TPU path hands it to its kernels
(``dgl_tpu/ops/bitmap_gat.py:455,468``):

- :func:`bitmap_gat_bwd_dst` (kernel B4, ``csrc/bitmap_gat_bwd_dst.cu``),
  dst-major: ``der[d] = dz[d] . (B @ h)[d] - c[d] rowsum(B)[d]``, one warp
  a dst row walking its in-edges from the relation's CSC, as B3 does;
- :func:`bitmap_gat_bwd_src` (kernel B5, ``csrc/bitmap_gat_bwd_src.cu``),
  src-major: ``dh[s] = (alpha^T dz)[s]`` and ``del[s] = h[s] . (B^T dz)[s]
  - (B^T c)[s]``, one warp a source row walking its out-edges from the
  relation's CSR (``csr_indptr`` / ``csr_indices``), which name the pairs
  of the transpose bitmap.

Their plain versions :func:`gat_bwd_dst_plain` and :func:`gat_bwd_src_plain`
compute the reference's ``_gat_xla_bwd`` (``dz`` and ``h`` taken as f32 of
their bf16 values, everything else f32) over the bits, on any subset of
bitmap rows.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _kernels
from .bitmap_spmm import BitmapPlan, _check_plan_rel, _expand_bits

__all__ = ["bitmap_gat", "bitmap_gat_fwd", "gat_fwd_plain",
           "bitmap_gat_bwd_dst", "bitmap_gat_bwd_src", "gat_bwd_dst_plain",
           "gat_bwd_src_plain", "BitmapPlan"]

_NEG = -1e30  # finite "-inf" of the reference's masked logits


def _leaky(x, slope):
    return torch.where(x > 0, x, x * slope)


def _dleaky(x, slope):
    return torch.where(x > 0, x.new_ones(()), x.new_full((), slope))


def _lse_guard(lse):
    """The reference's guard: a row whose ``lse`` is about ``_NEG`` (no
    in-edge on the TPU kernel's convention) gets ``-_NEG``, so its alpha
    underflows to 0 instead of cancelling the mask."""
    return torch.where(lse > _NEG / 2, lse, lse.new_full((), -_NEG))


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


def _chunk(heads, n_cols):
    return max(1, (1 << 26) // max(heads * n_cols, 1))


def gat_bwd_dst_plain(bits, el, er, h, slope, lse, c, dz, chunk=None):
    """Plain PyTorch version of B4 (the ``der`` of reference
    ``_gat_xla_bwd``) on the dst rows ``bits`` (R, W): ``el`` (n_src, H)
    with n_src <= 8 W, ``h`` (n_src, H, O) taken as f32 of its values, and
    the rows' ``er``, ``lse``, ``c`` (R, H) and ``dz`` (R, H, O), taken as
    f32 of its values. Returns
    ``der`` (R, H) f32, ``chunk`` rows at a time."""
    n_rows = bits.shape[0]
    n_src, heads = el.shape
    if chunk is None:
        chunk = _chunk(heads, n_src)
    f32 = torch.float32
    elT = el.to(f32).t().contiguous()                         # (H, n_src)
    erT, lseT, cT = (t.to(f32).t() for t in (er, _lse_guard(lse), c))
    hT = h.to(f32).permute(1, 2, 0).contiguous()              # (H, O, n_src)
    dzT = dz.to(f32).permute(1, 0, 2)                         # (H, R, O)
    der = torch.empty((n_rows, heads), dtype=f32, device=el.device)
    for c0 in range(0, n_rows, chunk):
        c1 = min(c0 + chunk, n_rows)
        mask = _expand_bits(bits[c0:c1])[:, :n_src].bool()   # (C, n_src)
        raw = erT[:, c0:c1, None] + elT[:, None, :]          # (H, C, n_src)
        alpha = torch.exp(_leaky(raw, slope) - lseT[:, c0:c1, None])
        alpha = torch.where(mask, alpha, alpha.new_zeros(()))
        dalpha = torch.bmm(dzT[:, c0:c1], hT)                # (H, C, n_src)
        dlogit = alpha * (dalpha - cT[:, c0:c1, None]) * _dleaky(raw, slope)
        der[c0:c1] = dlogit.sum(dim=2).t()
    return der


def gat_bwd_src_plain(bits_t, el, er, h, slope, lse, c, dz, chunk=None):
    """Plain PyTorch version of B5 (the ``del`` and ``dh`` of reference
    ``_gat_xla_bwd``) on the source rows ``bits_t`` (R, W_t) of the
    transpose bitmap: the rows' ``el`` (R, H) and ``h`` (R, H, O), and the
    destinations' ``dz`` (n_dst, H, O), taken as f32 of its values, and
    ``er``, ``lse``, ``c`` (>= n_dst, H), with n_dst <= 8 W_t. Returns
    ``del`` (R, H) and ``dh`` (R, H, O), f32, ``chunk`` rows at a time."""
    n_rows = bits_t.shape[0]
    n_dst, heads = dz.shape[0], dz.shape[1]
    if chunk is None:
        chunk = _chunk(heads, n_dst)
    f32 = torch.float32
    elT = el.to(f32).t()                                      # (H, R)
    erT, lseT, cT = (t[:n_dst].to(f32).t().contiguous()
                     for t in (er, _lse_guard(lse), c))       # (H, n_dst)
    hT = h.to(f32).permute(1, 0, 2)                           # (H, R, O)
    dzT = dz.to(f32).permute(1, 0, 2).contiguous()            # (H, n_dst, O)
    dele = torch.empty((n_rows, heads), dtype=f32, device=el.device)
    dh = torch.empty((n_rows, heads, h.shape[2]), dtype=f32, device=el.device)
    for c0 in range(0, n_rows, chunk):
        c1 = min(c0 + chunk, n_rows)
        mask = _expand_bits(bits_t[c0:c1])[:, :n_dst].bool()  # (C, n_dst)
        raw = elT[:, c0:c1, None] + erT[:, None, :]           # (H, C, n_dst)
        alpha = torch.exp(_leaky(raw, slope) - lseT[:, None, :])
        alpha = torch.where(mask, alpha, alpha.new_zeros(()))
        dalpha = torch.bmm(hT[:, c0:c1], dzT.transpose(1, 2))
        dlogit = alpha * (dalpha - cT[:, None, :]) * _dleaky(raw, slope)
        dele[c0:c1] = dlogit.sum(dim=2).t()
        dh[c0:c1] = torch.bmm(alpha, dzT).permute(1, 0, 2)
    return dele, dh


def bitmap_gat_fwd(bits, indptr, indices, el, er, h, slope, n_rows=None):
    """Kernel B3: ``out`` (n_rows, H, O) and ``lse`` (n_rows, H), both f32,
    of the attention over the first ``n_rows`` dst rows. Their in-edges are
    named twice, alike: by the plan's ``bits``, which the plain version
    reads, and by the relation's CSC, ``indptr`` (n_rows + 1,) and
    ``indices``, both int32, which the kernel reads (an index outside
    [0, n_src) is skipped). ``el`` (n_src, H) f32, ``er`` (>= n_rows, H)
    f32, ``h`` (n_src, H, O) bf16.

    A CUDA ``h`` runs the kernel; a CPU ``h`` runs the plain version, for
    which the CSC may be None."""
    n_rows = bits.shape[0] if n_rows is None else int(n_rows)
    _check_fwd(bits, indptr, indices, el, er, h, n_rows)
    if h.device.type == "cpu":
        return gat_fwd_plain(bits[:n_rows], el, er[:n_rows], h, slope)
    return _launch(indptr, indices, el, er, h, float(slope), n_rows)


def bitmap_gat_bwd_dst(bits, indptr, indices, el, er, h, slope, lse, c, dz,
                       n_rows=None):
    """Kernel B4: ``der`` (n_rows, H) f32 over the first ``n_rows`` dst rows.
    Their in-edges are named by the plan's ``bits``, which the plain version
    reads, and by the relation's CSC, ``indptr`` (n_rows + 1,) and
    ``indices``, both int32, which the kernel reads (an index outside
    [0, n_src) is skipped). ``el`` (n_src, H) f32, ``h`` (n_src, H, O) bf16;
    ``er``, ``lse``, ``c`` (>= n_rows, H) f32; ``dz`` (>= n_rows, H, O) bf16.

    A CUDA ``h`` runs the kernel; a CPU ``h`` runs the plain version, for
    which the CSC may be None."""
    n_rows = bits.shape[0] if n_rows is None else int(n_rows)
    n_src = h.shape[0]
    _check_bwd("CSC", bits, indptr, indices, el, h, dz,
               (("er", er, n_rows), ("lse", lse, n_rows), ("c", c, n_rows)),
               n_rows, n_src)
    if el.shape[0] != n_src or dz.shape[0] < n_rows:
        raise ValueError("el must have h's rows and dz >= n_rows")
    if h.device.type == "cpu":
        return gat_bwd_dst_plain(bits[:n_rows], el, er[:n_rows], h, slope,
                                 lse[:n_rows], c[:n_rows], dz[:n_rows])
    return _launch_bwd_dst(indptr, indices, el, er, h, float(slope), lse, c,
                           dz, n_rows)


def bitmap_gat_bwd_src(bits_t, indptr, indices, el, er, h, slope, lse, c, dz,
                       n_rows=None):
    """Kernel B5: ``del`` (n_rows, H) and ``dh`` (n_rows, H, O), f32, over
    the first ``n_rows`` source rows. Their out-edges are named by the
    transpose bitmap ``bits_t``, which the plain version reads, and by the
    relation's CSR, ``indptr`` (n_rows + 1,) and ``indices``, both int32,
    which the kernel reads (an index outside [0, n_dst) is skipped).
    ``el`` (>= n_rows, H) f32 and ``h`` (>= n_rows, H, O) bf16 per source;
    ``dz`` (n_dst, H, O) bf16 and ``er``, ``lse``, ``c`` (>= n_dst, H) f32
    per destination, n_dst <= 8 * bits_t.shape[1].

    A CUDA ``h`` runs the kernel; a CPU ``h`` runs the plain version, for
    which the CSR may be None."""
    n_rows = bits_t.shape[0] if n_rows is None else int(n_rows)
    n_dst = dz.shape[0]
    _check_bwd("CSR", bits_t, indptr, indices, el, h, dz,
               (("er", er, n_dst), ("lse", lse, n_dst), ("c", c, n_dst)),
               n_rows, n_dst)
    if el.shape[0] < n_rows or h.shape[0] < n_rows:
        raise ValueError("el and h must have >= n_rows rows")
    if h.device.type == "cpu":
        return gat_bwd_src_plain(bits_t[:n_rows], el[:n_rows], er, h[:n_rows],
                                 slope, lse, c, dz)
    return _launch_bwd_src(indptr, indices, el, er, h, float(slope), lse, c,
                           dz, n_rows)


def _pow2_at_least(n):
    p = 1
    while p < n:
        p *= 2
    return p


def _check_fwd(bits, indptr, indices, el, er, h, n_rows):
    """Argument checks of B3 and its plain version; raises ValueError. The
    CSC is the kernel's input: a CUDA ``h`` needs it, int32 on its device
    (int64 ids are refused, not converted)."""
    dev = h.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"bitmap_gat_fwd: unsupported device {dev}")
    if h.dtype != torch.bfloat16 or h.dim() != 3:
        raise ValueError(f"h must be 3-D bf16, got {h.dtype} "
                         f"{tuple(h.shape)}")
    n_src, heads, _ = h.shape
    if (el.dtype != torch.float32 or er.dtype != torch.float32
            or el.device != dev or er.device != dev
            or tuple(el.shape) != (n_src, heads) or er.dim() != 2
            or er.shape[1] != heads or er.shape[0] < n_rows):
        raise ValueError("el must be (n_src, H) and er (>= n_rows, H) f32 "
                         "on h's device")
    if bits.dtype != torch.uint8 or bits.dim() != 2 or bits.device != dev:
        raise ValueError("bits must be a 2-D uint8 bitmap on h's device")
    if bits.shape[1] % 512 or n_rows > bits.shape[0] or n_src > (
            bits.shape[1] * 8):
        raise ValueError(f"bitmap {tuple(bits.shape)} does not fit h "
                         f"{tuple(h.shape)} and n_rows={n_rows}")
    if indptr is None and indices is None and dev.type == "cpu":
        return
    for name, t in (("indptr", indptr), ("indices", indices)):
        if (not isinstance(t, torch.Tensor) or t.dtype != torch.int32
                or t.dim() != 1 or t.device != dev):
            raise ValueError(f"{name} must be a 1-D int32 tensor on h's "
                             "device: the relation's CSC")
    if indptr.numel() != n_rows + 1:
        raise ValueError(f"indptr has {indptr.numel()} entries, not "
                         f"n_rows + 1 = {n_rows + 1}")
    if indices.numel() + 4096 >= 2 ** 31:
        raise ValueError("more than 2^31 - 4096 edges: ids are int32")


def _launch(indptr, indices, el, er, h, slope, n_rows, nf=None):
    """B3 on checked inputs. ``nf``: the features per pass, the fewest
    passes' by default (:func:`_passes`); the tests also run others."""
    dev = h.device
    n_src, heads, odim = h.shape
    out = torch.empty((n_rows, heads, odim), dtype=torch.float32,
                      device=dev)
    lse = torch.empty((n_rows, heads), dtype=torch.float32, device=dev)
    if n_rows == 0 or heads == 0 or odim == 0:
        return out, lse
    nh, nf, h_pad, o_pad = _passes(heads, odim, nf)
    el, er = _pad_heads(el, h_pad), _pad_heads(er[:n_rows], h_pad)
    h = _pad_features(h, h_pad, o_pad)
    indptr, indices = indptr.contiguous(), indices.contiguous()
    lib = _kernels.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.dgl_bitmap_gat_fwd(
            indptr.data_ptr(), indices.data_ptr(), n_rows, el.data_ptr(),
            er.data_ptr(), h.data_ptr(), n_src, heads, odim, h_pad, o_pad,
            nh, nf, slope, out.data_ptr(), lse.data_ptr(), stream)
    _kernels.check(code, "bitmap_gat_fwd")
    _kernels.launch_counts["bitmap_gat_fwd"] += 1
    return out, lse


def _passes(heads, odim, nf=None, nh=None):
    """A pass holds nh heads x nf features per source (nh * nf <= 64), 8
    features a lane; heads and features pad to whole passes. ``nf`` by
    default: the least of 8, 16, 32, 64 that holds ``odim``, and ``nh`` the
    most heads such a pass holds, so the fewest passes, which every kernel
    runs (a B3 pass re-reads the ids and el and repeats every edge's
    logits: H=1, O=41 as three passes of 16 features measured slower than
    one of 64 on the H100, PERF.md). Returns (nh, nf, h_pad, o_pad)."""
    if nf is None:
        nf = next((f for f in (8, 16, 32) if odim <= f), 64)
    if nf not in (8, 16, 32, 64):
        raise ValueError(f"nf must be 8, 16, 32 or 64, got {nf}")
    if nh is None:
        nh = min(64 // nf, _pow2_at_least(heads))
    elif nh not in (1, 2, 4, 8) or nh * nf > 64:
        raise ValueError(f"nh must be 1, 2, 4 or 8 with nh * nf <= 64, "
                         f"got nh={nh}, nf={nf}")
    return nh, nf, -(-heads // nh) * nh, -(-odim // nf) * nf


def fwd_occupancy(heads, odim):
    """What the card runs B3 with at ``heads`` x ``odim``: the compiled
    kernel's registers, static shared bytes and local (stack and spill)
    bytes per thread, its resident blocks per SM, and the gather bytes an
    SM has in flight at that occupancy while all its warps gather."""
    nh, nf, _h_pad, _o_pad = _passes(heads, odim)
    out = (ctypes.c_int * 5)()
    code = _kernels.library().dgl_bitmap_gat_fwd_occupancy(
        nh, nf, ctypes.addressof(out))
    _kernels.check(code, "bitmap_gat_fwd_occupancy")
    keys = ("registers", "static_smem_bytes", "local_bytes_per_thread",
            "blocks_per_sm", "gather_bytes_in_flight_per_sm")
    return {"nh": nh, "nf": nf, **dict(zip(keys, out))}


def _aligned(x):
    """Contiguous and 16-byte aligned (the kernels' vector loads)."""
    x = x.contiguous()
    return x.clone() if x.data_ptr() % 16 else x


def _pad_heads(x, h_pad):
    """(n, H[, ...]) -> (n, h_pad[, ...]) with zero heads, contiguous."""
    if x.shape[1] != h_pad:
        pad = [0, 0] * (x.dim() - 2) + [0, h_pad - x.shape[1]]
        x = torch.nn.functional.pad(x, pad)
    return _aligned(x)


def _pad_features(x, h_pad, o_pad):
    """(n, H, O) -> (n, h_pad, o_pad) with zeros, contiguous and aligned."""
    if tuple(x.shape[1:]) != (h_pad, o_pad):
        x = torch.nn.functional.pad(x, (0, o_pad - x.shape[2],
                                        0, h_pad - x.shape[1]))
    return _aligned(x)


def _check_bwd(index, bits, indptr, indices, el, h, dz, row_ops, n_rows,
               n_cols):
    """Argument checks of B4 (``index="CSC"``) and B5 (``"CSR"``) and their
    plain versions; raises ValueError. ``n_cols``: the bitmap's column
    entities; ``row_ops``: the f32 (>= n, H) operands with their least row
    count. The relation's index is the kernel's input: a CUDA ``h`` needs
    it, int32 on its device (int64 ids are refused, not converted)."""
    dev = h.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"bitmap GAT backward: unsupported device {dev}")
    if h.dtype != torch.bfloat16 or h.dim() != 3:
        raise ValueError(f"h must be 3-D bf16, got {h.dtype} "
                         f"{tuple(h.shape)}")
    heads, odim = h.shape[1], h.shape[2]
    if (dz.dtype != torch.bfloat16 or dz.device != dev or dz.dim() != 3
            or tuple(dz.shape[1:]) != (heads, odim)):
        raise ValueError("dz must be (n, H, O) bf16 on h's device")
    for name, t, n in (("el", el, 0),) + tuple(row_ops):
        if (t.dtype != torch.float32 or t.device != dev or t.dim() != 2
                or t.shape[1] != heads or t.shape[0] < n):
            raise ValueError(f"{name} must be (>= {n}, H) f32 on h's device")
    if bits.dtype != torch.uint8 or bits.dim() != 2 or bits.device != dev:
        raise ValueError("bits must be a 2-D uint8 bitmap on h's device")
    n_bits_rows, W = bits.shape
    if W % 512 or n_rows > n_bits_rows or n_cols > W * 8:
        raise ValueError(f"bitmap {tuple(bits.shape)} does not fit "
                         f"n_rows={n_rows} and {n_cols} columns")
    if indptr is None and indices is None and dev.type == "cpu":
        return
    for name, t in (("indptr", indptr), ("indices", indices)):
        if (not isinstance(t, torch.Tensor) or t.dtype != torch.int32
                or t.dim() != 1 or t.device != dev):
            raise ValueError(f"{name} must be a 1-D int32 tensor on h's "
                             f"device: the relation's {index}")
    if indptr.numel() != n_rows + 1:
        raise ValueError(f"indptr has {indptr.numel()} entries, not "
                         f"n_rows + 1 = {n_rows + 1}")
    if indices.numel() + 4096 >= 2 ** 31:
        raise ValueError("more than 2^31 - 4096 edges: ids are int32")


def _launch_bwd_dst(indptr, indices, el, er, h, slope, lse, c, dz, n_rows):
    """B4 on checked inputs, the fewest passes."""
    n_src, heads, odim = h.shape
    dev = h.device
    der = torch.empty((n_rows, heads), dtype=torch.float32, device=dev)
    if n_rows == 0 or heads == 0 or odim == 0:
        return der
    nh, nf, h_pad, o_pad = _passes(heads, odim)
    el = _pad_heads(el, h_pad)
    er, lse, c = (_pad_heads(t[:n_rows], h_pad)
                  for t in (er, _lse_guard(lse[:n_rows]), c))
    h = _pad_features(h, h_pad, o_pad)
    dz = _pad_features(dz[:n_rows], h_pad, o_pad)
    indptr, indices = indptr.contiguous(), indices.contiguous()
    lib = _kernels.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.dgl_bitmap_gat_bwd_dst(
            indptr.data_ptr(), indices.data_ptr(), n_rows, el.data_ptr(),
            er.data_ptr(), lse.data_ptr(), c.data_ptr(), h.data_ptr(),
            dz.data_ptr(), n_src, heads, h_pad, o_pad, nh, nf, slope,
            der.data_ptr(), stream)
    _kernels.check(code, "bitmap_gat_bwd_dst")
    _kernels.launch_counts["bitmap_gat_bwd_dst"] += 1
    return der


def _launch_bwd_src(indptr, indices, el, er, h, slope, lse, c, dz, n_rows,
                    nh=None):
    """B5 on checked inputs. ``nh``: the heads per pass, the fewest
    passes' by default (:func:`_passes`); chip_smoke.py also times others."""
    n_dst = dz.shape[0]
    heads, odim = h.shape[1], h.shape[2]
    dev = h.device
    dele = torch.empty((n_rows, heads), dtype=torch.float32, device=dev)
    dh = torch.empty((n_rows, heads, odim), dtype=torch.float32, device=dev)
    if n_rows == 0 or heads == 0 or odim == 0:
        return dele, dh
    nh, nf, h_pad, o_pad = _passes(heads, odim, nh=nh)
    el = _pad_heads(el[:n_rows], h_pad)
    h = _pad_features(h[:n_rows], h_pad, o_pad)
    # the destinations' (er, lse, c) packed as one 16-byte gather per pair
    ed = torch.stack([er[:n_dst], _lse_guard(lse[:n_dst]), c[:n_dst],
                      torch.zeros_like(c[:n_dst])], dim=2)
    ed = _pad_heads(ed, h_pad)
    dz = _pad_features(dz, h_pad, o_pad)
    indptr, indices = indptr.contiguous(), indices.contiguous()
    lib = _kernels.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.dgl_bitmap_gat_bwd_src(
            indptr.data_ptr(), indices.data_ptr(), n_rows, el.data_ptr(),
            h.data_ptr(), ed.data_ptr(), dz.data_ptr(), n_dst, heads, odim,
            h_pad, o_pad, nh, nf, slope, dele.data_ptr(), dh.data_ptr(),
            stream)
    _kernels.check(code, "bitmap_gat_bwd_src")
    _kernels.launch_counts["bitmap_gat_bwd_src"] += 1
    return dele, dh


def bwd_occupancy(name, heads, odim, nh=None):
    """What the card runs B4 (``name="bitmap_gat_bwd_dst"``) or B5
    (``"bitmap_gat_bwd_src"``) with at ``heads`` x ``odim`` (B5's heads in
    passes of ``nh``): the compiled kernel's registers, static shared bytes
    and local (stack and spill) bytes per thread, its resident blocks per
    SM, and the gather bytes (of h for B4, of dz for B5) an SM has in
    flight at that occupancy while all its warps gather."""
    nh, nf, _h_pad, _o_pad = _passes(heads, odim, nh=nh)
    out = (ctypes.c_int * 5)()
    code = getattr(_kernels.library(), f"dgl_{name}_occupancy")(
        nh, nf, ctypes.addressof(out))
    _kernels.check(code, f"{name}_occupancy")
    keys = ("registers", "static_smem_bytes", "local_bytes_per_thread",
            "blocks_per_sm", "gather_bytes_in_flight_per_sm")
    return {"nh": nh, "nf": nf, **dict(zip(keys, out))}


def _prep(plan, el, er, h):
    """The reference's operand preparation, as the plain versions of B4 and
    B5 take it on the CPU: el and er in f32, h in bf16, el and h padded to
    the bitmap's column count, er to its row count. The kernels take the
    unpadded rows."""
    Hp, W = plan.bits.shape
    Ws = W * 8
    nheads, odim = int(el.shape[1]), int(h.shape[2])
    elp = _pad_rows(el.to(torch.float32), Ws)
    erp = _pad_rows(er.to(torch.float32), Hp)
    hp = _pad_rows(h.to(torch.bfloat16).reshape(h.shape[0], -1), Ws)
    return elp, erp, hp.reshape(Ws, nheads, odim)


class _BitmapGAT(torch.autograd.Function):
    """Bitmap-flash GAT: forward B3, backward B4 and B5 (reference
    ``_gat_fwd`` / ``_gat_bwd``). On the card each kernel walks the
    relation's index (B3 and B4 its CSC, B5 its CSR), so the relation is
    kept for the backward."""

    @staticmethod
    def forward(ctx, el, er, h, slope, plan, rel):
        csc = (None, None) if rel is None else (rel.csc_indptr,
                                                rel.csc_indices)
        out, lse = bitmap_gat_fwd(plan.bits, *csc, el.to(torch.float32),
                                  er.to(torch.float32),
                                  h.to(torch.bfloat16), slope, plan.num_dst)
        out = out.to(h.dtype)
        ctx.save_for_backward(el, er, h, lse, out)
        ctx.slope, ctx.plan, ctx.rel = slope, plan, rel
        return out

    @staticmethod
    def backward(ctx, dz):
        # detached: the kernels' operands carry no autograd history (on the
        # card el and er reach them uncopied)
        el, er, h, lse, out = (t.detach() for t in ctx.saved_tensors)
        plan, slope, rel = ctx.plan, ctx.slope, ctx.rel
        need_el, need_er, need_h = ctx.needs_input_grad[:3]
        if h.device.type == "cpu":
            elp, erp, hp = _prep(plan, el, er, h)
        else:
            elp, erp, hp = (el.to(torch.float32), er.to(torch.float32),
                            h.to(torch.bfloat16))
        csc = csr = (None, None)
        if rel is not None:
            csc = rel.csc_indptr, rel.csc_indices
            csr = rel.csr_indptr, rel.csr_indices
        # the kernels read only the real rows, so dz and out stay unpadded;
        # c[d, h] = out . dz from the f32 dz, then dz in bf16 for both
        # kernels (the reference's TPU path, bitmap_gat.py:447-468)
        dzf = dz.to(torch.float32)
        c = (out.to(torch.float32) * dzf).sum(dim=2)
        dzb = dzf.to(torch.bfloat16)
        d_el = d_er = d_h = None
        if need_er:
            d_er = bitmap_gat_bwd_dst(plan.bits, *csc, elp, erp, hp, slope,
                                      lse, c, dzb,
                                      plan.num_dst).to(er.dtype)
        if need_el or need_h:
            bits_t = plan.bits if plan.bits_rev is None else plan.bits_rev
            dele, dh = bitmap_gat_bwd_src(bits_t, *csr, elp, erp, hp, slope,
                                          lse, c, dzb, plan.num_src)
            d_el = dele.to(el.dtype) if need_el else None
            d_h = dh.to(h.dtype) if need_h else None
        return d_el, d_er, d_h, None, None, None


def bitmap_gat(slope, plan: BitmapPlan, el, er, h, rel=None):
    """Full-graph GAT aggregation over a bitmap plan.

    ``el`` (num_src, H): per-source logit halves; ``er`` (num_dst, H):
    per-destination halves; ``h`` (num_src, H, O): projected features.
    Returns (num_dst, H, O) in ``h.dtype``: ``sum_s alpha[s, d] h[s]`` with
    alpha the softmax of ``leaky(el[s] + er[d])`` over each destination's
    in-neighbours. ``rel``: the plan's relation, whose CSC the forward
    kernel and B4 walk and whose CSR B5 walks; on the CPU the plain versions
    read only the plan's bits, and ``rel`` may be None there."""
    if rel is not None:
        _check_plan_rel(plan, rel)
    return _BitmapGAT.apply(el, er, h, slope, plan, rel)
