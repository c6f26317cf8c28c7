"""The distributed layer (counterpart of ``dgl_tpu/distributed/``;
reference ``python/dgl/distributed/``).

Ported so far: offline partitioning (the multilevel partitioner of
``partition.py``, random assignment, the per-part files and their
loaders, heterographs through their homogeneous encoding), the range
partition book, and the process rank and count over
``torch.distributed``. The shards, halo exchange, distributed tensors,
key-value store and samplers are ROADMAP queue A11.
"""
from .dist_context import get_rank, get_world_size
from .graph_partition_book import RangePartitionBook
from .partition import (edge_cut, hetero_partition_assignment,
                        load_assignment, load_partition, load_partition_book,
                        metis_partition_assignment, partition_graph,
                        partition_hetero_graph, random_partition_assignment)

GraphPartitionBook = RangePartitionBook  # reference class name

__all__ = [
    "RangePartitionBook", "GraphPartitionBook", "get_rank",
    "get_world_size", "metis_partition_assignment",
    "random_partition_assignment", "partition_graph", "load_partition",
    "load_partition_book", "load_assignment", "hetero_partition_assignment",
    "partition_hetero_graph", "edge_cut",
]
