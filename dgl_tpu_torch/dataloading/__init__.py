"""Minibatch dataloading (counterpart of ``dgl_tpu/dataloading/``;
reference ``python/dgl/dataloading/``).

Samplers run on the host (numpy and ``csrc/host_ops.cpp``) and put their
blocks on the graph's device, or on the fixed-shape samplers' ``device``:
the ragged ``NeighborSampler``, ``MultiLayerFullNeighborSampler`` and
``LaborSampler`` of DGL's recipes, the fixed-shape samplers whose blocks
have the same shapes for every batch (homogeneous and heterogeneous), the
edge-prediction wrapper with its negative samplers, the subgraph samplers
(Cluster-GCN over the multilevel partitioner's parts, SAINT, ShaDow,
capped) and the ``DataLoader`` that samples ahead of its consumer in a
thread.
"""
from .base import (BlockSampler, EdgePredictionSampler, Sampler,
                   as_edge_prediction_sampler, find_exclude_eids)
from .capped import CappedNeighborSampler
from .collators import (Collator, DDPTensorizedDataset, EdgeCollator,
                        GraphCollator, NodeCollator, TensorizedDataset,
                        create_tensorized_dataset)
from .dataloader import DataLoader, EdgeDataLoader, NodeDataLoader
from .graph_loader import GraphDataLoader
from .hetero_sampler import HeteroFixedShapeNeighborSampler
from .negative_sampler import GlobalUniform, PerSourceUniform, Uniform
from .neighbor_sampler import (FixedShapeNeighborSampler, LaborSampler,
                               MultiLayerFullNeighborSampler,
                               MultiLayerNeighborSampler, NeighborSampler)
from .spot_target import SpotTarget
from .subgraph_samplers import (ClusterGCNSampler, SAINTSampler,
                                ShaDowKHopSampler)
from .worker_utils import (CollateWrapper, WorkerInitWrapper,
                           remove_parent_storage_columns,
                           restore_parent_storage_columns)

__all__ = [
    "EdgePredictionSampler", "TensorizedDataset", "DDPTensorizedDataset",
    "create_tensorized_dataset", "NodeCollator", "EdgeCollator",
    "GraphCollator", "Collator", "SpotTarget", "CappedNeighborSampler",
    "remove_parent_storage_columns", "restore_parent_storage_columns",
    "CollateWrapper", "WorkerInitWrapper", "GraphDataLoader", "Sampler",
    "BlockSampler", "as_edge_prediction_sampler", "find_exclude_eids",
    "NeighborSampler", "MultiLayerNeighborSampler",
    "MultiLayerFullNeighborSampler", "FixedShapeNeighborSampler",
    "LaborSampler", "DataLoader", "NodeDataLoader", "EdgeDataLoader",
    "Uniform", "GlobalUniform", "PerSourceUniform", "ClusterGCNSampler",
    "SAINTSampler", "ShaDowKHopSampler", "HeteroFixedShapeNeighborSampler",
]
