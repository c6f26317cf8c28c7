"""Multiprocessing helpers (counterpart of ``dgl_tpu/multiprocessing_mod.py``;
reference ``python/dgl/multiprocessing/``).

Worker processes start with ``torch.multiprocessing``'s ``spawn`` context:
a process that has initialised CUDA must not fork. Graphs reach workers
through POSIX shared memory (:meth:`Graph.shared_memory`,
:func:`hetero_from_shared_memory`) rather than through memory a fork
inherits.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.multiprocessing as _mp

__all__ = ["get_context", "Process", "Queue", "call_once_and_share"]


def get_context():
    """``torch.multiprocessing``'s spawn context (its queues pass tensors
    through shared memory)."""
    return _mp.get_context("spawn")


def Process(*args, **kwargs):
    return get_context().Process(*args, **kwargs)


def Queue(*args, **kwargs):
    return get_context().Queue(*args, **kwargs)


def call_once_and_share(fn, shape, dtype):
    """Run ``fn`` once and place its result in a new POSIX shared-memory
    block (reference ``multiprocessing/pytorch.py``): returns a host
    tensor over the block and the block's handle (pass ``handle.name`` to
    the workers; unlink it when done). ``dtype`` is a numpy or torch
    dtype."""
    from multiprocessing import shared_memory

    if isinstance(dtype, torch.dtype):
        dtype = torch.empty((), dtype=dtype).numpy().dtype
    value = fn()
    if isinstance(value, torch.Tensor):
        value = value.detach().cpu().numpy()
    arr = np.asarray(value, dtype=dtype).reshape(shape)
    shm = shared_memory.SharedMemory(create=True, size=max(arr.nbytes, 1))
    out = np.ndarray(shape, dtype=dtype, buffer=shm.buf)
    out[:] = arr
    return torch.from_numpy(out), shm
