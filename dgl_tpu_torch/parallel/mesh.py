"""Meshes of parts and their collectives (counterpart of
``dgl_tpu/parallel/mesh.py``; reference ``python/dgl/distributed/
dist_context.py:208`` process-group bring-up).

The JAX package writes each collective step as a per-device body inside
``shard_map`` over a ``jax.sharding.Mesh``. Here a :class:`Mesh` holds the
parts of its axes in one of two ways, behind one interface:

- **one process holding every part** (``group=None``): every part lives in
  this process on one device. A sharded tensor carries the part axis in
  front, as the JAX package's global ``(P, ...)`` arrays do, and the
  collectives are tensor ops: ``all_to_all`` of ``(P_src, P_dst, ...)``
  send buffers is a transpose of the first two axes, ``psum``/``pmean`` a
  sum or mean over the part axis, ``axis_index`` an ``arange``. Several
  parts can share one card this way, which NCCL refuses across processes;
- **one part per process** (``group=`` a ``torch.distributed`` process
  group): the same bodies see a part axis of length 1, and the collectives
  are ``all_to_all_single`` and ``all_reduce`` (NCCL on cards, gloo on the
  CPU). A 2-D mesh takes one subgroup per axis.

Every body is written once over the leading part axis; only the collective
differs. The mesh counts the bytes each part sends through ``all_to_all``,
split into integer and float (:attr:`Mesh.comm_bytes`), so the analytic
traffic of the distributed samplers can be held against what moved.
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["Mesh", "MeshAxes", "AXES", "create_mesh"]


@dataclass(frozen=True)
class MeshAxes:
    """Canonical axis names used across dgl_tpu_torch.parallel."""

    dp: str = "dp"  # data parallel (minibatch / seed-node sharding)
    tp: str = "tp"  # tensor parallel (embedding rows, wide hidden dims)
    gp: str = "gp"  # graph-partition parallel (node-partition shards + halo)


AXES = MeshAxes()


class _AllToAll(torch.autograd.Function):
    """``all_to_all`` over one axis; its backward is the same exchange of
    the gradient (the exchange is its own transpose)."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return mesh._exchange(x, axis)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh._exchange(g.contiguous(), ctx.axis), None, None


class _AllReduce(torch.autograd.Function):
    """Sum over one axis's processes; the gradient of every copy is the
    sum of the copies' gradients."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return mesh._reduce(x.clone(), axis)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh._reduce(g.clone(), ctx.axis), None, None


class Mesh:
    """Named axes of parts, held in one process or one part a process.

    ``shape`` maps each axis name to its size, as a JAX mesh's does.
    ``device`` is where this process's tensors live. With ``group`` (a
    process group of ``prod(shape)`` ranks, laid out row-major over the
    axes) each process holds one part of every axis; without it this
    process holds them all.
    """

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 device, group=None):
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {list(shape)} has {len(shape)} "
                             f"axes, names {tuple(axis_names)}")
        self.shape = OrderedDict((n, int(s))
                                 for n, s in zip(axis_names, shape))
        self.axis_names = tuple(axis_names)
        self.device = torch.device(device)
        self.group = group
        self.size = int(np.prod(shape)) if len(shape) else 1
        self.comm_bytes = {"int": 0, "float": 0}
        self._coords = None
        self._groups = {}
        if group is not None:
            import torch.distributed as dist

            world = dist.get_world_size(group)
            if world != self.size:
                raise ValueError(f"mesh shape {list(shape)} needs "
                                 f"{self.size} ranks, the group has {world}")
            rank = dist.get_rank(group)
            self._coords = dict(zip(self.axis_names,
                                    np.unravel_index(rank, tuple(shape))))
            self._make_subgroups(group)

    def _make_subgroups(self, group):
        """One subgroup per axis: the ranks that differ only in that
        axis's coordinate (every rank creates every group, in one order)."""
        import torch.distributed as dist

        if len(self.axis_names) == 1:
            self._groups[self.axis_names[0]] = group
            return
        ranks = np.arange(self.size).reshape(tuple(self.shape.values()))
        global_ranks = dist.get_process_group_ranks(group)
        for i, name in enumerate(self.axis_names):
            lines = np.moveaxis(ranks, i, -1).reshape(-1, ranks.shape[i])
            for line in lines:
                members = [global_ranks[r] for r in line]
                sub = dist.new_group(members)
                if dist.get_rank() in members:
                    self._groups[name] = sub

    # -- where the parts are --------------------------------------------

    @property
    def one_process(self) -> bool:
        """True when this process holds every part."""
        return self.group is None

    def parts(self, axis: str) -> int:
        """How many parts of ``axis`` this process holds (the length of a
        sharded tensor's leading axis here)."""
        return self.shape[axis] if self.one_process else 1

    def coord(self, axis: str) -> int:
        """This process's part of ``axis`` (0 in the one-process mesh)."""
        return 0 if self.one_process else int(self._coords[axis])

    def axis_index(self, axis: str) -> torch.Tensor:
        """The parts of ``axis`` held here, as a (parts,) int64 tensor:
        ``lax.axis_index`` over the leading part axis."""
        lo = self.coord(axis)
        return torch.arange(lo, lo + self.parts(axis), device=self.device)

    def local(self, x, axis: str = "gp"):
        """``x``'s parts held here, on the mesh's device: a tensor or
        array whose leading axis covers every part of ``axis`` is cut to
        this process's rows; one already cut is only moved."""
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.ascontiguousarray(x))
        n = self.shape[axis]
        if not self.one_process and x.dim() and x.shape[0] == n and n > 1:
            lo = self.coord(axis)
            x = x[lo:lo + 1]
        return x.to(self.device)

    # -- collectives ----------------------------------------------------

    def all_to_all(self, x: torch.Tensor, axis: str = "gp") -> torch.Tensor:
        """``lax.all_to_all(split_axis=0, concat_axis=0)`` of the send
        buffers ``x`` (parts, P, ...): entry ``[p, q]`` of the result is
        what part ``q`` sent to part ``p``. Differentiable."""
        P = self.shape[axis]
        if x.dim() < 2 or x.shape[1] != P or x.shape[0] != self.parts(axis):
            raise ValueError(f"all_to_all over {axis!r} takes ({self.parts(axis)}"
                             f", {P}, ...) send buffers, got {tuple(x.shape)}")
        return _AllToAll.apply(x, self, axis)

    def psum(self, x: torch.Tensor, axis: str = "gp") -> torch.Tensor:
        """The sum over the parts of ``axis``, every part's copy alike
        (parts, ...). Differentiable."""
        if self.one_process:
            return x.sum(0, keepdim=True).expand_as(x)
        return _AllReduce.apply(x, self, axis)

    def pmean(self, x: torch.Tensor, axis: str = "gp") -> torch.Tensor:
        return self.psum(x, axis) / self.shape[axis]

    def sum_grads(self, params, axis: str = "gp", mean: bool = False):
        """Sum (or average) the gradients of replicated ``params`` over the
        processes of ``axis``; a no-op on the one-process mesh, whose
        backward already summed every part's terms."""
        if self.one_process:
            return
        import torch.distributed as dist

        size = self.shape[axis]
        for p in params:
            if p.grad is not None and size > 1:
                dist.all_reduce(p.grad, group=self._groups[axis])
                if mean:
                    p.grad /= size

    def all_gather(self, x: torch.Tensor, axis: str = "gp") -> torch.Tensor:
        """Every part's (parts, ...) rows, (P, ...) (not differentiable;
        the one-process mesh already holds them)."""
        if self.one_process:
            return x
        import torch.distributed as dist

        out = [torch.empty_like(x) for _ in range(self.shape[axis])]
        dist.all_gather(out, x.contiguous(), group=self._groups[axis])
        return torch.cat(out)

    def reset_comm_bytes(self):
        self.comm_bytes = {"int": 0, "float": 0}

    def _count(self, x: torch.Tensor, axis: str):
        per_part = x.numel() // max(self.parts(axis), 1) * x.element_size()
        kind = "float" if x.dtype.is_floating_point else "int"
        self.comm_bytes[kind] += int(per_part)

    def _exchange(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        self._count(x, axis)
        if self.one_process:
            return x.transpose(0, 1).contiguous()
        import torch.distributed as dist

        send = x[0].contiguous()
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=self._groups[axis])
        return recv.unsqueeze(0)

    def _reduce(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        import torch.distributed as dist

        dist.all_reduce(x, group=self._groups[axis])
        return x

    def __repr__(self):
        where = "one process" if self.one_process else "one part a process"
        return f"Mesh({dict(self.shape)}, {self.device}, {where})"


def create_mesh(shape: Optional[Sequence[int]] = None,
                axis_names: Tuple[str, ...] = ("dp", "tp"), *,
                devices=None, group=None, device="cuda") -> Mesh:
    """A :class:`Mesh` (reference-shaped ``create_mesh``).

    Without ``group`` every part lives in this process on ``device``;
    ``devices`` is then the part count (an int, or a list of parts, all on
    that one device). With ``group`` (a ``torch.distributed`` process
    group, or ``True`` for the default one) each rank is one part, and
    ``device`` is this rank's device. ``shape=None`` puts every part on the
    first axis; a ``-1`` entry is inferred from the count, like a reshape.
    """
    if group is not None:
        import torch.distributed as dist

        if group is True:
            group = dist.group.WORLD
        n = dist.get_world_size(group)
    elif devices is None:
        n = None
    else:
        n = devices if isinstance(devices, int) else len(list(devices))
    if shape is None:
        shape = [n or 1] + [1] * (len(axis_names) - 1)
    shape = [int(s) for s in shape]
    if -1 in shape:
        if n is None:
            raise ValueError("a -1 in the mesh shape needs a part count")
        known = int(np.prod([s for s in shape if s != -1]))
        shape[shape.index(-1)] = n // known
    if n is not None and int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {shape} != {n} parts")
    return Mesh(shape, axis_names, device, group=group)
