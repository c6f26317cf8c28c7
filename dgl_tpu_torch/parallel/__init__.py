"""The parallel layer (counterpart of ``dgl_tpu/parallel/``): meshes of
parts and data-parallel steps.

The reference's collectives inside ``shard_map`` become a :class:`Mesh`'s:
tensor ops when one process holds every part, ``torch.distributed`` when
each process holds one (``mesh.py``). Batches shard over ``dp``, embedding
rows over ``tp``, graph partitions over ``gp`` (halo exchange).
"""
from .mesh import AXES, Mesh, MeshAxes, create_mesh
from .spmd import (PartitionSpec, param_shardings, replicate, shard_batch,
                   sharded_train_step)

__all__ = [
    "create_mesh",
    "MeshAxes",
    "Mesh",
    "shard_batch",
    "replicate",
    "param_shardings",
    "sharded_train_step",
    "PartitionSpec",
]
