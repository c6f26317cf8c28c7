"""Process-group bring-up, rank and count (counterpart of
``dgl_tpu/distributed/dist_context.py``; reference
``python/dgl/distributed/dist_context.py``), over ``torch.distributed``.

A process that has not joined a process group is rank 0 of 1, as one JAX
process is. ``initialize`` joins one when a coordinator is given, or when
``tools/launch.py`` set ``DGL_TPU_COORDINATOR``, ``DGL_TPU_NUM_PROCS`` and
``DGL_TPU_PROC_ID``; without either it does nothing. The backend is NCCL
for a process on a card and gloo for one on the CPU; a failed join raises.
"""
from __future__ import annotations

import os
from typing import Optional

import torch

__all__ = ["initialize", "get_rank", "get_world_size", "exit_client"]


def _group_ready() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def get_rank() -> int:
    """This process's rank in the default process group, 0 outside one."""
    import torch.distributed as dist

    return dist.get_rank() if _group_ready() else 0


def get_world_size() -> int:
    """The default process group's size, 1 outside one."""
    import torch.distributed as dist

    return dist.get_world_size() if _group_ready() else 1


def initialize(ip_config: Optional[str] = None,
               coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, *, device="cuda",
               backend: Optional[str] = None, **kwargs):
    """Join the default process group (reference ``dist_context.py:208``).

    ``coordinator_address`` is ``host:port`` of rank 0's store; without it
    the ``DGL_TPU_*`` variables of ``tools/launch.py`` are read, and
    without them this is a no-op (one process, rank 0 of 1).
    ``ip_config`` is accepted for the reference's signature. ``device``
    picks the backend (``"nccl"`` for a card, ``"gloo"`` for the CPU)
    unless ``backend`` names one; a card process is bound to card
    ``process_id`` modulo the visible count. A second call is a no-op.
    """
    import torch.distributed as dist

    if _group_ready():
        return
    if coordinator_address is None and "DGL_TPU_COORDINATOR" in os.environ:
        coordinator_address = os.environ["DGL_TPU_COORDINATOR"]
        num_processes = int(os.environ.get("DGL_TPU_NUM_PROCS", "1"))
        process_id = int(os.environ.get("DGL_TPU_PROC_ID", "0"))
    if coordinator_address is None:
        return
    num_processes = 1 if num_processes is None else int(num_processes)
    process_id = 0 if process_id is None else int(process_id)
    device = torch.device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id)


def exit_client():
    """Leave the default process group (reference ``dist_context.py:365``);
    a no-op outside one."""
    import torch.distributed as dist

    if _group_ready():
        dist.destroy_process_group()
