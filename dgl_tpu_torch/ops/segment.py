"""Segment ops over contiguous segments (counterpart of
``dgl_tpu/ops/segment.py``; reference ``python/dgl/ops/segment.py``).

``segment_reduce`` takes segment lengths, as the reference's
``SegmentReduce`` does. Rows past the lengths' sum belong to the last
segment, as ``dgl_tpu``'s ``jnp.repeat(..., total_repeat_length)`` puts
them (the readouts meet such rows in a padded graph's edge frames).
``segment_mm`` is the per-relation dense matmul of TypedLinear / R-GCN.
Plain PyTorch: the JAX package has no Pallas kernel for these, and
PyTorch's autograd differentiates them.

Ties of ``max``/``min``: both frameworks split the gradient of a tied
extremum evenly among the tied elements (``scatter_reduce``'s rule, and
the average of JAX's scatter-extremal JVP).
"""
from __future__ import annotations

import torch

from ..base import DGLError

__all__ = ["segment_reduce", "segment_softmax", "segment_mm"]


def _seg_ids(seglen, total):
    """The segment of each of ``total`` rows (no read on the host): the
    last segment's past the lengths' sum."""
    ends = torch.cumsum(seglen.to(torch.int64), 0)
    pos = torch.arange(total, device=seglen.device)
    return torch.searchsorted(ends, pos, right=True).clamp(
        max=max(seglen.shape[0] - 1, 0))


def _segment_cmp(ids, value, n, reducer):
    """Max or min per segment; empty segments keep the initial 0."""
    idx = ids.reshape((-1,) + (1,) * (value.dim() - 1)).expand_as(value)
    out = value.new_zeros((n,) + tuple(value.shape[1:]))
    return out.scatter_reduce(0, idx, value,
                              "amax" if reducer == "max" else "amin",
                              include_self=False)


def segment_reduce(seglen, value, reducer="sum"):
    """Reduce contiguous segments of ``value`` (reference ``segment.py:8``):
    ``sum``, ``mean``, ``max`` or ``min``; empty segments give 0."""
    n = seglen.shape[0]
    ids = _seg_ids(seglen, value.shape[0])
    if reducer in ("sum", "mean"):
        out = value.new_zeros((n,) + tuple(value.shape[1:])).index_add(
            0, ids, value)
        if reducer == "mean":
            deg = torch.clamp(seglen, min=1).to(out.dtype)
            out = out / deg.reshape((n,) + (1,) * (out.dim() - 1))
        return out
    if reducer in ("max", "min"):
        out = _segment_cmp(ids, value, n, reducer)
        has = (seglen > 0).reshape((n,) + (1,) * (out.dim() - 1))
        return torch.where(has, out, 0)
    raise DGLError(f"Unknown reducer {reducer!r}")


def segment_softmax(seglen, value):
    """Softmax within each contiguous segment (reference ``segment.py:56``).
    A segment whose maximum is not finite is shifted by 0, as in the
    reference."""
    n = seglen.shape[0]
    ids = _seg_ids(seglen, value.shape[0])
    smax = _segment_cmp(ids, value, n, "max")
    smax = torch.where(torch.isfinite(smax), smax, 0.0)
    z = torch.exp(value - smax[ids])
    ssum = z.new_zeros(smax.shape).index_add(0, ids, z)
    return z / torch.clamp(ssum, min=1e-38)[ids]


def segment_mm(a, b, seglen_a):
    """Per-segment dense matmul: segment i of ``a`` @ ``b[i]`` (reference
    ``dgl.ops.segment_mm``). ``a``: (E, K); ``b``: (R, K, N); ``seglen_a``:
    (R,) lengths summing to E. Products in f32, result in ``a``'s dtype, as
    the reference's ``preferred_element_type``."""
    lens = [int(v) for v in seglen_a.tolist()]
    if sum(lens) != a.shape[0]:
        raise DGLError(f"segment lengths sum to {sum(lens)}, not "
                       f"{a.shape[0]}")
    parts = [seg.float() @ b[r].float()
             for r, seg in enumerate(torch.split(a, lens))]
    out = (torch.cat(parts) if parts
           else a.new_zeros((0, b.shape[-1]), dtype=torch.float32))
    return out.to(a.dtype)
