"""DistTensor / DistEmbedding (counterpart of
``dgl_tpu/distributed/dist_tensor.py``; reference
``python/dgl/distributed/dist_tensor.py:21``,
``distributed/nn/pytorch/sparse_emb.py:9``).

The reference stores rows in a KVStore and pulls them over RPC; here a
DistTensor is row-sharded over a mesh axis: its rows are padded to a
multiple of the axis size, part ``p`` owning the ``p``-th block of rows
The tensor is kept whole on the mesh's device
(the one-process mesh holds every part), so reads of arbitrary global rows
are plain gathers."""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

__all__ = ["DistTensor", "DistEmbedding"]


class DistTensor:
    """Row-sharded tensor over a mesh axis. Without a mesh it lives on
    ``device``."""

    def __init__(self, shape, dtype=torch.float32, name=None, *,
                 mesh=None, axis: str = "gp", init_func=None, data=None,
                 device="cuda"):
        self.name = name
        self._mesh = mesh
        self._axis = axis
        device = mesh.device if mesh is not None else torch.device(device)
        if data is None:
            data = (torch.zeros(shape, dtype=dtype)
                    if init_func is None else init_func(shape, dtype))
        data = torch.as_tensor(data).to(device)
        if mesh is not None:
            pad = (-shape[0]) % mesh.shape[axis]
            if pad:
                data = torch.cat([data, data.new_zeros(
                    (pad,) + tuple(shape[1:]))])
        self._data = data
        self._num_rows = shape[0]

    @property
    def shape(self):
        return (self._num_rows,) + tuple(self._data.shape[1:])

    @property
    def dtype(self):
        return self._data.dtype

    def __getitem__(self, idx):
        return self._data[idx]

    def __setitem__(self, idx, val):
        self._data = self._data.index_put(
            (torch.as_tensor(idx, device=self._data.device),),
            torch.as_tensor(val, dtype=self._data.dtype,
                            device=self._data.device))

    def __len__(self):
        return self._num_rows

    @property
    def data(self):
        return self._data


class DistEmbedding(DistTensor):
    """Trainable sharded embedding table (reference ``sparse_emb.py:9``),
    uniform in [-1, 1) from numpy's ``default_rng(seed)`` as the
    reference's. Train it with :mod:`~dgl_tpu_torch.distributed.optim`'s
    row-sparse optimisers."""

    def __init__(self, num_embeddings, embedding_dim, name=None, *,
                 mesh=None, axis: str = "gp", init_func=None, seed=0,
                 device="cuda"):
        if init_func is None:
            rng = np.random.default_rng(seed)

            def init_func(shape, dtype):
                return torch.from_numpy(
                    rng.uniform(-1.0, 1.0, shape)).to(dtype)

        super().__init__((num_embeddings, embedding_dim), torch.float32,
                         name, mesh=mesh, axis=axis, init_func=init_func,
                         device=device)

    def __call__(self, ids):
        return self._data[torch.as_tensor(ids, device=self._data.device)]
