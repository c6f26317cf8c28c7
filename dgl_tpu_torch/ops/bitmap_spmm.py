"""Bitmap-packed dense SpMM (counterpart of ``dgl_tpu/ops/bitmap_spmm.py``).

At Reddit density (E / N^2 ~ 2e-3) the adjacency of a relation is stored
as a packed bitmap, one bit per (dst, src) cell: N^2 / 8 bytes, 6.8 GB for
Reddit. ``copy_u + sum`` then reads the bitmap row by row and adds the
source rows whose bits are set.

Layout (the reference's, bit for bit): ``bits`` is (rup(num_dst, 512),
rup(num_src, 4096) / 8) uint8, PLANE-PACKED: within each 4096-column block,
byte ``b`` of a row carries bit ``j`` for source ``block*4096 + j*512 + b``.

:func:`bitmap_matmul` runs the hand-written CUDA kernel
(``dgl_tpu_torch/csrc/bitmap_spmm.cu``, which walks the set bits instead of
expanding the tile) on a CUDA tensor, and the plain PyTorch version
:func:`bitmap_matmul_plain` (the reference's ``_expand_bits`` +
``_bitmap_matmul_xla``) on a CPU tensor. Both multiply the 0/1 matrix by
``x`` rounded to bf16 and sum in f32.

Semantics: exact ``copy_u + sum`` over a simple graph (the builder refuses
multi-edges). The backward is the same matmul over the transpose bitmap,
``du = A^T dz`` through ``bits_rev`` (``bits`` itself when the relation is
symmetric), as the reference's ``_bitmap_bwd``.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import _kernels

__all__ = ["BitmapPlan", "bitmap_bytes", "build_bitmap_plan",
           "bitmap_copy_u_sum", "bitmap_matmul", "bitmap_matmul_plain",
           "unpack_host"]

_C = 512   # dst rows per tile of the reference kernel (bits rows pad to it)
_S = 4096  # src cols per tile; a row's bytes pad to a multiple of _S / 8
_PW = _S // 8  # 512 bytes per 4096-source block


def _rup(x: int, m: int) -> int:
    return max(int(-(-x // m) * m), m)


def bitmap_bytes(num_src: int, num_dst: int, symmetric: bool) -> int:
    """Device bytes a plan would occupy (for the auto gate)."""
    fwd = _rup(num_dst, _C) * (_rup(num_src, _S) // 8)
    if symmetric and num_src == num_dst:
        return fwd
    rev = _rup(num_src, _C) * (_rup(num_dst, _S) // 8)
    return fwd + rev


class BitmapPlan:
    """Packed adjacency bitmaps of one relation.

    ``bits``: (rup(num_dst, 512), rup(num_src, 4096)/8) uint8 in the
    plane-packed layout. ``bits_rev``: the transpose bitmap for the
    backward, None when the relation is symmetric and square (``bits``
    serves both directions). ``num_edges`` and ``edge_hash``: the
    relation's edge count (set bits) and ``Relation.edge_hash()``, which let
    a consumer check that a relation is the plan's.
    """

    def __init__(self, bits, bits_rev, *, num_src: int, num_dst: int,
                 num_edges: int, edge_hash: int,
                 compute_dtype: str = "bfloat16"):
        self.bits = bits
        self.bits_rev = bits_rev
        self.num_src = int(num_src)
        self.num_dst = int(num_dst)
        self.num_edges = int(num_edges)
        self.edge_hash = int(edge_hash)
        self.compute_dtype = str(compute_dtype)

    def to(self, device) -> "BitmapPlan":
        return BitmapPlan(
            self.bits.to(device),
            None if self.bits_rev is None else self.bits_rev.to(device),
            num_src=self.num_src, num_dst=self.num_dst,
            num_edges=self.num_edges, edge_hash=self.edge_hash,
            compute_dtype=self.compute_dtype)

    @property
    def device(self) -> torch.device:
        return self.bits.device

    def __repr__(self):
        return (f"BitmapPlan({self.num_dst}x{self.num_src}, "
                f"{'sym' if self.bits_rev is None else 'asym'}, "
                f"{self.bits.numel() / 1e6:.0f}MB)")


def _plane_coords(src):
    """src id -> (byte column, bit) in the plane-packed layout (numpy
    arrays or torch tensors)."""
    col = (src // _S) * _PW + src % _PW
    bit = (src % _S) // _PW
    return col, bit


def _pack(src, dst, num_src: int, num_dst: int) -> torch.Tensor:
    """(rup(num_dst, 512), rup(num_src, 4096)/8) uint8 plane-packed rows,
    built on the indices' device (counterpart of the reference's
    ``_pack_host``).

    The reference ORs ``1 << bit`` into each byte. The caller has refused
    multi-edges, so every (byte, bit) pair is set at most once and an
    integer sum of the bits equals their OR: one ``index_add_`` into int32
    words (four bytes each, little-endian) builds the same bytes."""
    H = _rup(num_dst, _C)
    W = _rup(num_src, _S) // 8
    col, bit = _plane_coords(src.to(torch.int64))
    byte = dst.to(torch.int64) * W + col
    shift = (byte & 3) * 8 + bit
    del col, bit
    val = torch.bitwise_left_shift(torch.ones_like(shift), shift)
    # bit 31 is the int32 sign bit: carry it as the two's-complement value
    val = torch.where(val >= 2 ** 31, val - 2 ** 32, val).to(torch.int32)
    words = torch.zeros(H * W // 4, dtype=torch.int32, device=src.device)
    words.index_add_(0, byte >> 2, val)
    return words.view(torch.uint8).reshape(H, W)


def unpack_host(bits: np.ndarray) -> np.ndarray:
    """Plane-packed rows -> dense 0/1 uint8 (tests / verification)."""
    H, W = bits.shape
    nb = W // _PW
    r = bits.reshape(H, nb, 1, _PW)
    sh = np.arange(8, dtype=np.uint8).reshape(1, 1, 8, 1)
    return ((r >> sh) & 1).reshape(H, W * 8)


def build_bitmap_plan(rel, max_bytes: int = 2 << 30,
                      compute_dtype: str = "bfloat16"):
    """Build on the relation's device; None when the relation has
    multi-edges (a bit cannot count two parallel edges) or the bitmaps
    exceed ``max_bytes``. A symmetric square relation keeps one bitmap."""
    if compute_dtype != "bfloat16":
        raise NotImplementedError(
            f"bitmap plan compute_dtype {compute_dtype!r}: only bfloat16 is "
            "ported (ROADMAP queue C)")
    if rel.num_edges == 0:
        return None
    uniq = rel.edge_keys()
    if uniq.numel() != rel.num_edges:
        return None  # multi-edges
    src = rel.src[:rel.num_edges].to(torch.int64)
    dst = rel.dst[:rel.num_edges].to(torch.int64)
    symmetric = rel.num_src == rel.num_dst
    if symmetric:
        rev = torch.unique(src * rel.num_dst + dst)
        symmetric = torch.equal(uniq, rev)
        del rev
    del uniq
    if bitmap_bytes(rel.num_src, rel.num_dst, symmetric) > max_bytes:
        return None
    bits = _pack(src, dst, rel.num_src, rel.num_dst)
    bits_rev = (None if symmetric
                else _pack(dst, src, rel.num_dst, rel.num_src))
    return BitmapPlan(bits, bits_rev, num_src=rel.num_src,
                      num_dst=rel.num_dst, num_edges=rel.num_edges,
                      edge_hash=rel.edge_hash(), compute_dtype=compute_dtype)


# ---------------------------------------------------------------------------
# the matmul: bits (Hp, W) uint8 @ x (n_src <= W*8, F) -> (n_rows, F) f32
# ---------------------------------------------------------------------------


def _expand_bits(b):
    """(C, W) uint8 plane-packed -> (C, W*8) 0/1 uint8."""
    C, W = b.shape
    r = b.reshape(C, W // _PW, 1, _PW)
    sh = torch.arange(8, dtype=torch.uint8, device=b.device).reshape(
        1, 1, 8, 1)
    return torch.bitwise_and(torch.bitwise_right_shift(r, sh), 1).reshape(
        C, W * 8)


def bitmap_matmul_plain(bits, x, n_rows=None, chunk: int = 1024):
    """Plain PyTorch version: expand ``chunk`` dst rows at a time to a
    dense 0/1 f32 matrix and multiply by ``x`` rounded to bf16, in f32.
    Returns (n_rows, F) f32 (``n_rows`` defaults to all bitmap rows)."""
    n_rows = bits.shape[0] if n_rows is None else int(n_rows)
    n_src = x.shape[0]
    xf = x.to(torch.bfloat16).to(torch.float32)
    out = torch.empty((n_rows, x.shape[1]), dtype=torch.float32,
                      device=x.device)
    for c0 in range(0, n_rows, chunk):
        c1 = min(c0 + chunk, n_rows)
        a = _expand_bits(bits[c0:c1])[:, :n_src].to(torch.float32)
        out[c0:c1] = a @ xf
    return out


def bitmap_matmul(bits, x, n_rows=None):
    """``out[d] = sum_{s: bit (d, s) set} bf16(x[s])`` in f32 for the first
    ``n_rows`` bitmap rows. ``bits``: plane-packed uint8 bitmap; ``x``:
    (n_src, F) with n_src <= 8 * bits.shape[1].

    A CUDA ``x`` runs the kernel; a CPU ``x`` runs the plain version."""
    if x.device.type == "cpu":
        return bitmap_matmul_plain(bits, x, n_rows)
    if not x.is_cuda:
        raise ValueError(f"bitmap_matmul: unsupported device {x.device}")
    return _launch(bits, x, bits.shape[0] if n_rows is None else int(n_rows))


def _launch(bits, x, n_rows):
    dev = x.device
    if bits.dtype != torch.uint8 or bits.dim() != 2 or bits.device != dev:
        raise ValueError("bits must be a 2-D uint8 bitmap on x's device")
    if x.dim() != 2:
        raise ValueError(f"x must be 2-D, got {tuple(x.shape)}")
    n_bits_rows, W = bits.shape
    n_src, feat = x.shape
    if W % _PW or n_rows > n_bits_rows or n_src > W * 8:
        raise ValueError(f"bitmap {tuple(bits.shape)} does not fit x "
                         f"{tuple(x.shape)} and n_rows={n_rows}")
    out = torch.empty((n_rows, feat), dtype=torch.float32, device=dev)
    if n_rows == 0 or feat == 0:
        return out
    # a pass covers 8 features on each of `lanes` lanes per source; x is
    # padded to whole passes so every row gather is 16-byte loads
    lanes = 1 if feat <= 8 else 2 if feat <= 16 else 4 if feat <= 32 else 8
    fp = _rup(feat, 8 * lanes)
    xb = x.to(torch.bfloat16)
    if fp != feat or not xb.is_contiguous() or xb.data_ptr() % 16:
        xp = torch.zeros((n_src, fp), dtype=torch.bfloat16, device=dev)
        xp[:, :feat] = xb
        xb = xp
    bits = bits.contiguous()
    lib = _kernels.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.dgl_bitmap_spmm(bits.data_ptr(), n_rows, W,
                                   xb.data_ptr(), n_src, fp, feat, lanes,
                                   out.data_ptr(), stream)
    _kernels.check(code, "bitmap_spmm")
    _kernels.launch_counts["bitmap_spmm"] += 1
    return out


class _BitmapCopyUSum(torch.autograd.Function):
    """The bitmap SpMM; its backward runs the same kernel over ``A^T``."""

    @staticmethod
    def forward(ctx, u, plan):
        ctx.plan = plan
        return bitmap_matmul(plan.bits, u, plan.num_dst).to(u.dtype)

    @staticmethod
    def backward(ctx, dz):
        plan = ctx.plan
        bits_t = plan.bits if plan.bits_rev is None else plan.bits_rev
        # dz rounds to bf16 as the forward rounds u (reference _bitmap_bwd)
        du = bitmap_matmul(bits_t, dz, plan.num_src)
        return du.to(dz.dtype), None


def bitmap_copy_u_sum(plan: BitmapPlan, u):
    """``out[d] = sum_{s: (s,d) in E} u[s]`` for 2-D ``u`` (num_src, F):
    matches ``ops.copy_u_sum`` on a simple graph to bf16 class (the rows
    are rounded to bf16, the sums are f32). Returns ``u.dtype``."""
    return _BitmapCopyUSum.apply(u, plan)
