"""Cooperative minibatching: the sparse all-to-all (counterpart of
``dgl_tpu/distributed/cooperative.py``; reference
``python/dgl/graphbolt/impl/cooperative_conv.py:12-135``,
``impl/neighbor_sampler.py:555-639``, ``python/dgl/cuda/nccl.py:7,98``).

Ids are exchanged by owner part, each owner serves its rows, and the rows
go back: owner-masked request and response buffers moved by a
:class:`~dgl_tpu_torch.parallel.Mesh`'s ``all_to_all``, all shapes static.
The pull is differentiable in the table: the backward is the reverse
exchange, as the reference's ``CooperativeConvFunction.backward``.
"""
from __future__ import annotations

import numpy as np
import torch

from .dist_spmm import _rows_of

__all__ = ["sparse_all_to_all_pull", "sparse_all_to_all_push"]


def _ranges_on(ranges, device) -> torch.Tensor:
    if isinstance(ranges, torch.Tensor):
        return ranges.to(device=device, dtype=torch.int64)
    return torch.as_tensor(np.asarray(ranges, np.int64), device=device)


def _id_dtype(ranges: torch.Tensor):
    """The exchanged ids' dtype: int32 while the ids fit, as the
    reference's."""
    return torch.int32 if int(ranges[-1]) < 2 ** 31 else torch.int64


def _owners(ranges, ids, nparts: int):
    """(L, P, B) one-hot of each id's owner part."""
    owner = torch.searchsorted(ranges, ids.to(torch.int64).contiguous(),
                               right=True) - 1
    parts = torch.arange(nparts, device=ids.device)
    return owner[:, None, :] == parts[None, :, None]


def sparse_all_to_all_pull(mesh, ranges, table, ids, axis: str = "gp"):
    """Pull rows of a row-sharded table for arbitrary global ids.

    ``ranges``: (P+1,) global row ranges per part (RangePartitionBook).
    ``table``: (P, rows_max, F) part-major local rows (or the (L, ...)
    held here). ``ids``: (P, B) global ids each part requests
    (out-of-range ids, like padding, return zeros). Returns the (L, B, F)
    rows of the parts held here. Differentiable in ``table``. Not-mine
    request slots carry -1 and the receiver rebuilds the mask from its own
    range, so one request/response ``all_to_all`` pair moves everything.
    """
    table = mesh.local(table, axis)
    ids = mesh.local(ids, axis).to(torch.int64).contiguous()
    ranges = _ranges_on(ranges, mesh.device)
    nparts = mesh.shape[axis]
    owner = torch.clamp(torch.searchsorted(ranges, ids, right=True) - 1,
                        0, nparts - 1)
    onehot = owner[:, None, :] == torch.arange(
        nparts, device=ids.device)[None, :, None]                # (L, P, B)
    req = torch.where(onehot, ids[:, None, :], -1).to(_id_dtype(ranges))
    req_t = mesh.all_to_all(req, axis).to(torch.int64)
    me = mesh.axis_index(axis)
    lo, hi = ranges[me][:, None, None], ranges[me + 1][:, None, None]
    mine = (req_t >= lo) & (req_t < hi)
    local = torch.clamp(req_t - lo, 0, table.shape[1] - 1)
    rows = _rows_of(table, local) * mine[..., None].to(table.dtype)
    resp = mesh.all_to_all(rows, axis)
    # resp[l, q, i]: the row of my id i served by part q; one q is valid
    return resp.sum(1)


def sparse_all_to_all_push(mesh, ranges, grads, ids, rows_max: int,
                           axis: str = "gp"):
    """Push per-id gradient rows to their owning parts (reference
    ``nccl.py`` ``sparse_all_to_all_push``): ``grads`` (P, B, F) and
    ``ids`` (P, B) -> (L, rows_max, F) summed into part-local rows."""
    grads = mesh.local(grads, axis)
    ids = mesh.local(ids, axis)
    ranges = _ranges_on(ranges, mesh.device)
    nparts = mesh.shape[axis]
    onehot = _owners(ranges, ids, nparts)                        # (L, P, B)
    send = grads[:, None] * onehot[..., None].to(grads.dtype)    # (L,P,B,F)
    send_ids = torch.where(onehot, ids[:, None, :].to(torch.int64), 0).to(
        _id_dtype(ranges))
    recv = mesh.all_to_all(send, axis)
    recv_ids = mesh.all_to_all(send_ids, axis)
    recv_m = mesh.all_to_all(onehot.to(torch.int32), axis)
    me = mesh.axis_index(axis)
    L = grads.shape[0]
    local = torch.where(recv_m > 0,
                        recv_ids.to(torch.int64) - ranges[me][:, None, None],
                        rows_max)                                # (L, P, B)
    seg = (local + torch.arange(L, device=grads.device)[:, None, None]
           * (rows_max + 1)).reshape(-1)
    F = grads.shape[-1]
    out = grads.new_zeros((L * (rows_max + 1), F)).index_add(
        0, seg, recv.reshape(-1, F))
    return out.reshape(L, rows_max + 1, F)[:, :rows_max]
