"""Partition-parallel g-SpMM with halo exchange (counterpart of
``dgl_tpu/distributed/dist_spmm.py``; reference DistDGL's data plane,
``graph_services.py:737``).

Boundary features move in one ``all_to_all`` over the ``gp`` axis of a
:class:`~dgl_tpu_torch.parallel.Mesh`; each part then reduces its edges in
the extended (local + halo) source space. Every body runs over the leading
part axis: all parts at once on the one-process mesh, one part a process
across processes. The reduction is a gather and an ``index_add_`` (or
``scatter_reduce`` for max/min), which the reference leaves to XLA.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..base import DGLError
from .shard import GraphShards

__all__ = ["halo_exchange", "dist_copy_u_sum", "dist_spmm", "shard_arrays",
           "init_halo_state", "dist_copy_u_sum_delayed"]

_TABLES = ("src_ext", "dst_local", "send_idx", "send_mask", "in_deg")


def shard_arrays(mesh, shards: GraphShards, axis: str = "gp") -> dict:
    """The shard index tables of the parts held here, on the mesh's
    device."""
    return {k: mesh.local(getattr(shards, k), axis) for k in _TABLES}


def _rows_of(x, idx):
    """Per part ``l``: ``x[l][idx[l]]`` for ``x`` (L, n, ...) and ``idx``
    (L, ...) -> (L, ...idx, ...x)."""
    L, n = x.shape[0], x.shape[1]
    flat = x.reshape((L * n,) + x.shape[2:])
    off = torch.arange(L, device=x.device).reshape((L,) + (1,) * (
        idx.dim() - 1)) * n
    out = flat.index_select(0, (idx.long() + off).reshape(-1))
    return out.reshape(tuple(idx.shape) + tuple(x.shape[2:]))


def halo_exchange(mesh, x_local, send_idx, send_mask, axis: str = "gp"):
    """Gather each part's boundary rows for every destination part and
    ``all_to_all`` them: ``x_local`` (L, n_max, F), ``send_idx`` and
    ``send_mask`` (L, P, h_max) -> (L, P, h_max, F) halo rows received
    (slot [l, q] = rows from part q)."""
    sb = _rows_of(x_local, send_idx) * send_mask[..., None].to(
        x_local.dtype)
    return mesh.all_to_all(sb, axis)


def _segment(msgs, dst_local, n_max: int, reduce_op: str):
    """Per part, reduce (L, e, F) messages into n_max rows by
    ``dst_local``; padding edges (dst n_max) fall into a dropped row."""
    L, e, F = msgs.shape
    seg = (dst_local.long() + torch.arange(
        L, device=msgs.device)[:, None] * (n_max + 1)).reshape(-1)
    flat = msgs.reshape(L * e, F)
    out = msgs.new_zeros((L * (n_max + 1), F))
    if reduce_op in ("max", "min"):
        out = out.scatter_reduce(
            0, seg[:, None].expand(-1, F), flat,
            "amax" if reduce_op == "max" else "amin", include_self=False)
    else:
        out = out.index_add(0, seg, flat)
    out = out.reshape(L, n_max + 1, F)[:, :n_max]
    if reduce_op in ("max", "min"):
        # rows without an edge, and infinite extrema: 0, as the
        # single-device convention
        out = torch.where(torch.isfinite(out), out, torch.zeros_like(out))
    return out


def _local_spmm(x_local, recv, src_ext, dst_local, n_max: int,
                edge_vals=None, reduce_op: str = "sum"):
    L, Pn, h_max, F = recv.shape
    ext = torch.cat([x_local, recv.reshape(L, Pn * h_max, F)], dim=1)
    msgs = _rows_of(ext, src_ext)
    if edge_vals is not None:
        msgs = msgs * edge_vals[..., None]
    return _segment(msgs, dst_local, n_max, reduce_op)


def _mean(out, in_deg):
    return out / torch.clamp(in_deg, min=1.0)[..., None]


def dist_copy_u_sum(mesh, shards: GraphShards, x, tables=None,
                    axis: str = "gp", mean: bool = False):
    """Distributed ``copy_u`` + ``sum`` (or mean) over the shards.

    ``x``: the parts' features (P, n_max, F) part-major (see
    ``shards.shard_features``), or the (L, n_max, F) held here. Returns
    the aggregated destination rows of the parts held here.
    """
    if tables is None:
        tables = shard_arrays(mesh, shards, axis)
    x = mesh.local(x, axis)
    recv = halo_exchange(mesh, x, tables["send_idx"], tables["send_mask"],
                         axis)
    out = _local_spmm(x, recv, tables["src_ext"], tables["dst_local"],
                      shards.n_max)
    return _mean(out, tables["in_deg"]) if mean else out


def dist_spmm(mesh, shards: GraphShards, x, edge_vals=None, tables=None,
              axis: str = "gp", reduce_op: str = "sum"):
    """General distributed g-SpMM: message ``x[src]`` (times
    ``edge_vals``, (P, e_max) per-edge scalars, if given), reduced by
    sum, mean, max or min."""
    if reduce_op not in ("sum", "mean", "max", "min"):
        raise DGLError(f"Unknown reduce op {reduce_op!r}")
    if tables is None:
        tables = shard_arrays(mesh, shards, axis)
    x = mesh.local(x, axis)
    ev = None if edge_vals is None else mesh.local(edge_vals, axis)
    recv = halo_exchange(mesh, x, tables["send_idx"], tables["send_mask"],
                         axis)
    out = _local_spmm(x, recv, tables["src_ext"], tables["dst_local"],
                      shards.n_max, edge_vals=ev, reduce_op=reduce_op)
    return _mean(out, tables["in_deg"]) if reduce_op == "mean" else out


def init_halo_state(mesh, shards: GraphShards, feat_dim: int,
                    dtype=torch.float32, axis: str = "gp"):
    """Zero halo cache (L, P, h_max, F) for the delayed aggregation."""
    return torch.zeros((mesh.parts(axis), shards.num_parts, shards.h_max,
                        feat_dim), dtype=dtype, device=mesh.device)


def dist_copy_u_sum_delayed(mesh, shards: GraphShards, x, halo_state,
                            tables=None, axis: str = "gp",
                            mean: bool = False):
    """Delayed-halo aggregation (reference distgnn, ``python/dgl/
    distgnn/``): remote edges read the PREVIOUS iteration's halo rows
    while the fresh exchange runs. Returns ``(out, new_halo_state)``;
    thread the state through the training loop (one-iteration
    staleness)."""
    if tables is None:
        tables = shard_arrays(mesh, shards, axis)
    x = mesh.local(x, axis)
    fresh = halo_exchange(mesh, x, tables["send_idx"], tables["send_mask"],
                          axis)
    out = _local_spmm(x, mesh.local(halo_state, axis), tables["src_ext"],
                      tables["dst_local"], shards.n_max)
    return (_mean(out, tables["in_deg"]) if mean else out), fresh
