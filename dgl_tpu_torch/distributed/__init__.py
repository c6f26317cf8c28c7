"""The distributed layer (counterpart of ``dgl_tpu/distributed/``;
reference ``python/dgl/distributed/``, ``src/rpc/``).

The reference's server/client RPC architecture becomes:

- offline partitioning (``partition_graph``: the multilevel partitioner
  or random assignment, per-part files and a partition book);
- fixed-shape shards with precomputed halo routing tables
  (``build_shards``, ``build_hetero_shards``), every part the same shapes;
- halo exchange, sparse pulls and the distributed samplers over a
  :class:`~dgl_tpu_torch.parallel.Mesh`'s ``all_to_all``: tensor ops when
  one process holds every part (several parts on one card), NCCL or gloo
  through ``torch.distributed`` when each process holds one
  (``initialize``);
- host-sampled distributed minibatches (``DistNeighborSampler``,
  ``DistNodeDataLoader``) and the on-device ``DeviceDistSampler``;
- ``DistTensor``/``DistEmbedding`` with row-sparse optimisers, the host
  KV store, the server pieces and the graph services.
"""
from ..dataloading import DataLoader as DistDataLoader  # reference name:
# seed-sharded loading is the ddp_rank/ddp_world_size args of DataLoader
# (reference dist_dataloader.py:23)
from ..dataloading.collators import Collator, EdgeCollator, NodeCollator
from . import graph_services, optim
from .cooperative import sparse_all_to_all_pull, sparse_all_to_all_push
from .device_dist_sampler import DeviceDistSampler, shard_csc_arrays
from .dist_context import exit_client, get_rank, get_world_size, initialize
from .dist_graph import (DistGraph, edge_split, node_split,
                         sample_neighbors)
from .dist_minibatch import (DistEdgeDataLoader, DistEtypeNeighborSampler,
                             DistNeighborSampler, DistNodeDataLoader,
                             PartitionedGraphCSC, node_split_by_owner,
                             pull_rows_in_shard_map, stack_blocks)
from .dist_spmm import (dist_copy_u_sum, dist_copy_u_sum_delayed, dist_spmm,
                        halo_exchange, init_halo_state, shard_arrays)
from .dist_tensor import DistEmbedding, DistTensor
from .graph_partition_book import RangePartitionBook
from .graph_services import (ServerState, default_pull_handler,
                             default_push_handler,
                             dgl_partition_to_graphbolt, find_edges,
                             gb_convert_single_dgl_partition, in_degrees,
                             load_partition_feats, merge_graphs, out_degrees,
                             process_partitions)
from .hetero_shard import (HeteroGraphShards, build_hetero_shards,
                           dist_hetero_copy_u_sum,
                           dist_hetero_copy_u_sum_delayed,
                           init_hetero_halo_state)
from .kvstore import (DistConnectError, EdgePartitionPolicy, HeteroDataName,
                      IdMap, KVClient, KVServer, NodePartitionPolicy,
                      PartitionPolicy, parse_hetero_data_name)
from .optim import DistSparseGradOptimizer
from .partition import (edge_cut, hetero_partition_assignment,
                        load_assignment, load_partition, load_partition_book,
                        metis_partition_assignment, partition_graph,
                        partition_hetero_graph, random_partition_assignment)
from .role import (alltoall, alltoall_cpu, alltoallv, alltoallv_cpu,
                   close_kvstore, get_global_rank, get_kvstore,
                   get_local_usable_addr, get_num_trainers, get_role,
                   get_trainer_rank, init_kvstore, init_role,
                   local_ip4_addr_list, read_ip_config)
from .server import (CustomPool, DistGraphServer, EdgeDataView,
                     HeteroEdgeView, HeteroNodeView, MpCommand, NodeDataView,
                     PlaceHolder)
from .shard import GraphShards, build_shards

GraphPartitionBook = RangePartitionBook  # reference class name

__all__ = [
    "DeviceDistSampler", "shard_csc_arrays", "RangePartitionBook",
    "GraphPartitionBook", "DistGraph", "sample_neighbors", "node_split",
    "edge_split", "exit_client", "DistDataLoader", "PartitionPolicy",
    "NodePartitionPolicy", "EdgePartitionPolicy", "HeteroDataName",
    "parse_hetero_data_name", "IdMap", "KVServer", "KVClient",
    "DistConnectError", "DistGraphServer", "CustomPool", "MpCommand",
    "NodeDataView", "EdgeDataView", "HeteroNodeView", "HeteroEdgeView",
    "PlaceHolder", "optim", "DistSparseGradOptimizer", "NodeCollator",
    "EdgeCollator", "Collator", "merge_graphs", "find_edges", "in_degrees",
    "out_degrees", "load_partition_feats", "dgl_partition_to_graphbolt",
    "gb_convert_single_dgl_partition", "process_partitions",
    "default_push_handler", "default_pull_handler", "ServerState",
    "init_role", "get_role", "init_kvstore", "get_kvstore", "close_kvstore",
    "get_trainer_rank", "get_num_trainers", "get_global_rank",
    "read_ip_config", "get_local_usable_addr", "local_ip4_addr_list",
    "alltoall", "alltoall_cpu", "alltoallv", "alltoallv_cpu",
    "metis_partition_assignment", "random_partition_assignment",
    "partition_graph", "load_partition", "load_partition_book",
    "GraphShards", "build_shards", "dist_copy_u_sum", "dist_spmm",
    "halo_exchange", "HeteroGraphShards", "build_hetero_shards",
    "dist_hetero_copy_u_sum", "init_hetero_halo_state",
    "dist_hetero_copy_u_sum_delayed", "DistTensor", "DistEmbedding",
    "initialize", "get_rank", "get_world_size", "sparse_all_to_all_pull",
    "sparse_all_to_all_push", "PartitionedGraphCSC", "DistNeighborSampler",
    "DistNodeDataLoader", "DistEdgeDataLoader", "DistEtypeNeighborSampler",
    "pull_rows_in_shard_map", "stack_blocks",
    # the port's own
    "load_assignment", "hetero_partition_assignment",
    "partition_hetero_graph", "edge_cut", "shard_arrays", "init_halo_state",
    "dist_copy_u_sum_delayed", "node_split_by_owner",
]
