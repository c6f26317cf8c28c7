"""Bitmap-packed dense SpMM (counterpart of ``dgl_tpu/ops/bitmap_spmm.py``).

At Reddit density (E / N^2 ~ 2e-3) the adjacency of a relation is stored
as a packed bitmap, one bit per (dst, src) cell: N^2 / 8 bytes, 6.8 GB for
Reddit. ``copy_u + sum`` then reads the bitmap row by row and adds the
source rows whose bits are set.

Layout (the reference's, bit for bit): ``bits`` is (rup(num_dst, 512),
rup(num_src, 4096) / 8) uint8, PLANE-PACKED: within each 4096-column block,
byte ``b`` of a row carries bit ``j`` for source ``block*4096 + j*512 + b``.

:func:`bitmap_matmul` runs the hand-written CUDA kernel B2
(``dgl_tpu_torch/csrc/bitmap_spmm.cu``) on a CUDA tensor, and the plain
PyTorch version :func:`bitmap_matmul_plain` (the reference's
``_expand_bits`` + ``_bitmap_matmul_xla``) on a CPU tensor. The kernel does
not read the bits: one warp a row walks the row's edge list from the
relation's index, its CSC (``csc_indptr`` / ``csc_indices``) forward and
its CSR backward. The plan refuses multi-edges, so the index names exactly
the pairs of the bits, which the plain version reads; the card's check
compares the two representations. Both multiply the 0/1 matrix by
``x`` in the plan's ``compute_dtype`` and sum in f32: ``"bfloat16"`` rounds
``x`` to bf16 (about 4e-3 relative a row), ``"float32"`` keeps it in f32
and gives exact f32 sums, as the reference documents (its CPU path; the
plain version's product runs in full f32 whatever the process's TF32
setting). The kernel has an instantiation for each type.

Semantics: ``copy_u + sum`` over a simple graph (the builder refuses
multi-edges). The backward is the same matmul over the transpose bitmap,
``du = A^T dz`` through ``bits_rev`` (``bits`` itself when the relation is
symmetric; the kernel walks the CSR), in the same type, as the
reference's ``_bitmap_bwd``.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import _kernels
from ._precision import full_f32

__all__ = ["BitmapPlan", "bitmap_bytes", "build_bitmap_plan",
           "bitmap_copy_u_sum", "bitmap_matmul", "bitmap_matmul_plain",
           "unpack_host"]

_C = 512   # dst rows per tile of the reference kernel (bits rows pad to it)
_S = 4096  # src cols per tile; a row's bytes pad to a multiple of _S / 8
_PW = _S // 8  # 512 bytes per 4096-source block
# compute_dtype -> (x's type in the product, the launch count's name)
_TYPES = {"bfloat16": (torch.bfloat16, "bitmap_spmm"),
          "float32": (torch.float32, "bitmap_spmm_f32")}


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
    a consumer check that a relation is the plan's. ``compute_dtype``:
    ``"bfloat16"`` or ``"float32"``, the type ``x`` is multiplied in.
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
    exceed ``max_bytes``. A symmetric square relation keeps one bitmap.
    ``compute_dtype`` (``"bfloat16"`` or ``"float32"``) changes no bit;
    the plan records it."""
    if compute_dtype not in _TYPES:
        raise ValueError(f"bitmap plan compute_dtype must be bfloat16 or "
                         f"float32, got {compute_dtype!r}")
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


def bitmap_matmul_plain(bits, x, n_rows=None, chunk: int = 1024,
                        compute_dtype: str = "bfloat16"):
    """Plain PyTorch version: expand ``chunk`` dst rows at a time to a
    dense 0/1 f32 matrix and multiply by ``x`` in ``compute_dtype`` (bf16
    rounds it), in full f32. Returns (n_rows, F) f32 (``n_rows`` defaults
    to all bitmap rows)."""
    n_rows = bits.shape[0] if n_rows is None else int(n_rows)
    n_src = x.shape[0]
    xf = x.to(_TYPES[compute_dtype][0]).to(torch.float32)
    out = torch.empty((n_rows, x.shape[1]), dtype=torch.float32,
                      device=x.device)
    with full_f32():
        for c0 in range(0, n_rows, chunk):
            c1 = min(c0 + chunk, n_rows)
            a = _expand_bits(bits[c0:c1])[:, :n_src].to(torch.float32)
            out[c0:c1] = a @ xf
    return out


def bitmap_matmul(bits, x, n_rows=None, compute_dtype: str = "bfloat16", *,
                  indptr=None, indices=None):
    """``out[d] = sum_{s: bit (d, s) set} cd(x[s])`` in f32 for the first
    ``n_rows`` rows, ``cd`` the ``compute_dtype`` (``"bfloat16"`` rounds
    the rows, ``"float32"`` keeps them). ``x``: (n_src, F).

    A CUDA ``x`` runs the kernel, which reads only the relation's index:
    ``indptr`` (``n_rows + 1`` entries, ``n_rows`` by default) and
    ``indices``, 1-D int32 on ``x``'s device, the CSC of the relation whose
    bits these are (the CSR for ``bits_rev``); int64 ids are refused, not
    converted. ``bits`` is not read there and may be None. A CPU ``x`` runs
    the plain version over ``bits``, the plane-packed uint8 bitmap
    (n_src <= 8 * bits.shape[1]); an index passed there is checked and not
    read."""
    if compute_dtype not in _TYPES:
        raise ValueError(f"compute_dtype must be bfloat16 or float32, got "
                         f"{compute_dtype!r}")
    dev = x.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"bitmap_matmul: unsupported device {dev}")
    if x.dim() != 2:
        raise ValueError(f"x must be 2-D, got {tuple(x.shape)}")
    if dev.type == "cpu":
        n_rows = _check_bits(bits, x, n_rows)
        if indptr is not None or indices is not None:
            _check_index(indptr, indices, dev, n_rows)
        return bitmap_matmul_plain(bits, x, n_rows,
                                   compute_dtype=compute_dtype)
    if n_rows is None:
        n_rows = indptr.numel() - 1 if isinstance(indptr, torch.Tensor) else 0
    n_rows = int(n_rows)
    _check_index(indptr, indices, dev, n_rows)
    return _launch(indptr, indices, x, n_rows, compute_dtype)


def _check_bits(bits, x, n_rows) -> int:
    """Checks of the plain version's bitmap; returns ``n_rows`` (all
    bitmap rows by default). Raises ValueError."""
    if (not isinstance(bits, torch.Tensor) or bits.dtype != torch.uint8
            or bits.dim() != 2 or bits.device != x.device):
        raise ValueError("bits must be a 2-D uint8 bitmap on x's device")
    n_rows = bits.shape[0] if n_rows is None else int(n_rows)
    if (bits.shape[1] % _PW or n_rows > bits.shape[0]
            or x.shape[0] > bits.shape[1] * 8):
        raise ValueError(f"bitmap {tuple(bits.shape)} does not fit x "
                         f"{tuple(x.shape)} and n_rows={n_rows}")
    return n_rows


def _check_index(indptr, indices, dev, n_rows):
    """Checks of the kernel's input, the relation's index: 1-D int32 on
    ``dev``, ``indptr`` of ``n_rows + 1`` entries. Raises ValueError."""
    for name, t in (("indptr", indptr), ("indices", indices)):
        if (not isinstance(t, torch.Tensor) or t.dtype != torch.int32
                or t.dim() != 1 or t.device != dev):
            raise ValueError(f"{name} must be a 1-D int32 tensor on x's "
                             "device: the relation's CSC (CSR for the "
                             "transpose)")
    if indptr.numel() != n_rows + 1:
        raise ValueError(f"indptr has {indptr.numel()} entries, not "
                         f"n_rows + 1 = {n_rows + 1}")
    if indices.numel() + 4096 >= 2 ** 31:
        raise ValueError("more than 2^31 - 4096 edges: ids are int32")


def _lanes(feat: int):
    """A pass covers 8 features on each of ``lanes`` lanes per source; x is
    padded to whole passes (``fp`` columns) so every row gather is 16-byte
    loads. Returns (lanes, fp)."""
    lanes = 1 if feat <= 8 else 2 if feat <= 16 else 4 if feat <= 32 else 8
    return lanes, _rup(feat, 8 * lanes)


def _launch(indptr, indices, x, n_rows, compute_dtype):
    """B2 on checked inputs."""
    dev = x.device
    n_src, feat = x.shape
    out = torch.empty((n_rows, feat), dtype=torch.float32, device=dev)
    if n_rows == 0 or feat == 0:
        return out
    lanes, fp = _lanes(feat)
    cd, name = _TYPES[compute_dtype]
    xb = x.to(cd)
    if fp != feat or not xb.is_contiguous() or xb.data_ptr() % 16:
        xp = torch.zeros((n_src, fp), dtype=cd, device=dev)
        xp[:, :feat] = xb
        xb = xp
    indptr, indices = indptr.contiguous(), indices.contiguous()
    lib = _kernels.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.dgl_bitmap_spmm(indptr.data_ptr(), indices.data_ptr(),
                                   n_rows, xb.data_ptr(),
                                   int(cd == torch.bfloat16), n_src, fp,
                                   feat, lanes, out.data_ptr(), stream)
    _kernels.check(code, name)
    _kernels.launch_counts[name] += 1
    return out


class _BitmapCopyUSum(torch.autograd.Function):
    """The bitmap SpMM; its backward runs the same kernel over ``A^T``.
    Each call hands :func:`bitmap_matmul` the bits and the relation's
    index, and the wrapper reads one of them by ``x``'s device: on the card
    the kernel walks the relation's CSC forward and its CSR backward, so
    the relation is kept for the backward; on the CPU the plain version
    reads the bits."""

    @staticmethod
    def forward(ctx, u, plan, rel):
        ctx.plan, ctx.rel = plan, rel
        csc = {} if rel is None else {"indptr": rel.csc_indptr,
                                      "indices": rel.csc_indices}
        return bitmap_matmul(plan.bits, u, plan.num_dst, plan.compute_dtype,
                             **csc).to(u.dtype)

    @staticmethod
    def backward(ctx, dz):
        plan, rel = ctx.plan, ctx.rel
        bits_t = plan.bits if plan.bits_rev is None else plan.bits_rev
        csr = {} if rel is None else {"indptr": rel.csr_indptr,
                                      "indices": rel.csr_indices}
        # dz in f32, then in the plan's type as the forward takes u
        # (reference _bitmap_bwd): bf16 rounds it
        du = bitmap_matmul(bits_t, dz.to(torch.float32), plan.num_src,
                           plan.compute_dtype, **csr)
        return du.to(dz.dtype), None, None


def _check_plan_rel(plan, rel):
    """The plan must be the relation's: the same node and edge counts and
    the same edge set (``Relation.edge_hash``, counted once a relation)."""
    for what in ("num_src", "num_dst", "num_edges"):
        if getattr(plan, what) != getattr(rel, what):
            raise ValueError(f"bitmap plan and relation disagree on {what}: "
                             f"{getattr(plan, what)} != "
                             f"{getattr(rel, what)}")
    if plan.edge_hash != rel.edge_hash():
        raise ValueError("bitmap plan and relation disagree on their edge "
                         "sets: the plan was built from another relation")


def bitmap_copy_u_sum(plan: BitmapPlan, u, rel=None):
    """``out[d] = sum_{s: (s,d) in E} u[s]`` for 2-D ``u`` (num_src, F):
    matches ``ops.copy_u_sum`` on a simple graph to bf16 class with
    ``compute_dtype="bfloat16"`` (the rows are rounded to bf16, the sums
    are f32), to f32 rounding with ``"float32"``. Returns ``u.dtype``.
    ``rel``: the plan's relation, whose CSC the kernel walks forward and
    whose CSR it walks backward; on the CPU the plain version reads only
    the plan's bits, and ``rel`` may be None there."""
    if rel is not None:
        _check_plan_rel(plan, rel)
    return _BitmapCopyUSum.apply(u, plan, rel)
