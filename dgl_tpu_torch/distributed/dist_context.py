"""Process rank and count (counterpart of
``dgl_tpu/distributed/dist_context.py``; reference
``python/dgl/distributed/dist_context.py``), over ``torch.distributed``.

A process that has not joined a process group is rank 0 of 1, as one JAX
process is. Setting the group up (``initialize``) and tearing it down
(``exit_client``) belong with the rest of the distributed layer, ROADMAP
queue A11, and raise until it is ported.
"""
from __future__ import annotations

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


def initialize(*args, **kwargs):
    """(reference ``dist_context.py:208``): the distributed layer is
    ROADMAP queue A11."""
    raise NotImplementedError(
        "distributed.initialize: the distributed layer is ROADMAP queue A11")


def exit_client():
    """(reference ``dist_context.py:365``): ROADMAP queue A11."""
    raise NotImplementedError(
        "distributed.exit_client: the distributed layer is ROADMAP queue A11")
