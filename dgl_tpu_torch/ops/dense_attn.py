"""Dense masked attention for small graphs (counterpart of
``dgl_tpu/ops/dense_attn.py``).

On a small graph, graph attention is masked multi-head attention: the
(N_dst, N_src) adjacency mask is built once, the logits of all pairs are
computed, the softmax is masked and one batched product aggregates. The
reference's per-edge route (``gatconv.py:337-346``: g-SDDMM ``u_add_v``,
``edge_softmax``, ``u_mul_e`` g-SpMM) is hundreds of small operations a
layer; this is about thirty, on N_dst * N_src * H elements, the right trade
whenever that product is small (the default gate is 16M cells).

Exactness: the same function as edge softmax + ``u_mul_e_sum`` on a graph
without multi-edges (a multi-edge has two softmax slots, the mask one: the
builder refuses such graphs). Zero-in-degree destinations get zero rows.

The reference computes the batched product with ``dot_general`` outside
any kernel, bf16 operands giving an f32 result; here ``torch.bmm``
multiplies the bf16-valued operands in f32 (``bmm`` on bf16 would return
bf16), under PyTorch's default of no TF32 for f32 products
(``torch.backends.cuda.matmul.allow_tf32``). Gradients come from PyTorch's
autograd, as the reference's come from JAX's.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["DenseAdjPlan", "build_dense_adj", "dense_masked_attention"]


class DenseAdjPlan:
    """(N_dst, N_src) boolean adjacency for the dense attention route."""

    def __init__(self, mask, *, num_src: int, num_dst: int):
        self.mask = mask
        self.num_src = int(num_src)
        self.num_dst = int(num_dst)

    def to(self, device) -> "DenseAdjPlan":
        return DenseAdjPlan(self.mask.to(device), num_src=self.num_src,
                            num_dst=self.num_dst)

    def __repr__(self):
        return f"DenseAdjPlan({self.num_dst}x{self.num_src})"


def build_dense_adj(rel, max_cells: int = 16_000_000):
    """Build the mask on the relation's device; None when the relation has
    more than ``max_cells`` cells, none, or multi-edges (softmax over
    duplicate slots has no dense equivalent)."""
    cells = rel.num_src * rel.num_dst
    if cells == 0 or cells > max_cells or rel.has_multi_edges():
        return None
    src, dst = rel.host_arrays("src", "dst")
    src, dst = src[: rel.num_edges], dst[: rel.num_edges]
    mask = torch.zeros((rel.num_dst, rel.num_src), dtype=torch.bool,
                       device=rel.device)
    mask[torch.from_numpy(dst.astype(np.int64)).to(rel.device),
         torch.from_numpy(src.astype(np.int64)).to(rel.device)] = True
    return DenseAdjPlan(mask, num_src=rel.num_src, num_dst=rel.num_dst)


def dense_masked_attention(plan: DenseAdjPlan, el, er, h_src,
                           negative_slope: float = 0.2, dropout_fn=None,
                           return_alpha: bool = False, compute_dtype=None):
    """``out[d] = sum_s softmax_s(leaky_relu(el[s] + er[d]) | mask) h[s]``.

    ``el`` (N_src, H), ``er`` (N_dst, H), ``h_src`` (N_src, H, O); returns
    (N_dst, H, O) in ``h_src``'s type. One (H, N_dst, N_src) logits tensor
    in ``compute_dtype`` (default ``el``'s), a masked softmax whose sum is
    f32, and one batched product with an f32 result. ``dropout_fn``
    (optional) maps the attention probabilities, as the reference's
    ``attn_drop``.
    """
    cd = compute_dtype or el.dtype
    logits = er.t()[:, :, None].to(cd) + el.t()[:, None, :].to(cd)
    # the slope as a tensor of the logits' type: the reference multiplies
    # by the slope rounded to that type (a weak-typed Python float)
    slope = torch.tensor(negative_slope, dtype=cd, device=logits.device)
    logits = torch.where(logits >= 0, logits, slope * logits)
    mask = plan.mask[None]
    logits = torch.where(mask, logits, torch.tensor(-torch.inf, dtype=cd,
                                                    device=logits.device))
    m = logits.amax(-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, 0)  # all-masked rows stay finite
    p = torch.where(mask, torch.exp(logits - m), 0)
    # 1e-30, not 1e-38: the reference's XLA flushes f32 subnormals to zero
    denom = torch.clamp(p.to(torch.float32).sum(-1, keepdim=True), min=1e-30)
    alpha = (p / denom.to(cd)).to(cd)  # (H, N_dst, N_src)
    if dropout_fn is not None:
        alpha = dropout_fn(alpha)
    out = torch.bmm(alpha.to(torch.float32),
                    h_src.permute(1, 0, 2).to(cd).to(torch.float32))
    out = out.to(h_src.dtype).permute(1, 0, 2)  # (N_dst, H, O)
    if return_alpha:
        return out, alpha
    return out
