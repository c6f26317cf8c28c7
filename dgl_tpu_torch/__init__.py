"""dgl_tpu_torch: the PyTorch / CUDA port of ``dgl_tpu`` for NVIDIA Hopper.

Plain tensor code is PyTorch; the JAX package's Pallas kernels become CUDA
kernels written for ``sm_90a`` under ``csrc/``, built at first use
(``_kernels.py``). Entry points place their tensors on ``device``, which
defaults to ``"cuda"``; pass ``device="cpu"`` to run the plain PyTorch
versions of the kernels on the CPU.

Ported so far: full-graph GraphSAGE inference through the dense-hub SpMM
(graph construction, ``reorder_for_spmm``, ``update_all`` with the builtin
sum/mean reducers, ``SAGEConv``, ``GraphSAGE``), and full-graph GCN and GAT
inference through the bitmap path (``with_spmm_plans(bitmap=...)``,
``GraphConv``, ``GCN``, ``GATConv``, ``GAT``), full-graph training of all
three, the per-edge message-passing layer (g-SDDMM, edge softmax, the
max/min reducers, segment ops, ``apply_edges``/``apply_nodes`` and
user-defined functions) that carries GAT on sparse graphs, and the opt-in
hub-cache g-SpMM (``ops.hub_cache``), and minibatch GraphSAGE training:
fixed-shape MFG blocks (``create_block``) from the host sampler
(``dataloading.FixedShapeNeighborSampler``) through the uniform-stride
g-SpMM and edge softmax, and the on-device sampler
(``sampling.DeviceNeighborSampler``, ``device_seed_batches``) with
``models.DeviceSAGE``; heterogeneous graphs (``heterograph``,
``to_homogeneous``, ``to_heterogeneous``, blocks between node types),
``multi_update_all`` and subset propagation (``pull``, ``push``,
``send_and_recv``), ``nn.HeteroGraphConv``, ``nn.RelGraphConv`` and
``models.RGCN``; the typed linears (``nn.TypedLinear``,
``nn.HeteroLinear``, ``nn.HeteroEmbedding``), ``nn.HGTConv`` and the
convs ``GATv2Conv``, ``DotGatConv``, ``AGNNConv``, ``EGATConv``,
``EdgeGATConv``, ``GINConv``, ``GINEConv``, ``EdgeConv``, ``SGConv``,
``APPNPConv``, ``TAGConv``, ``ChebConv``, ``GCN2Conv``,
``GatedGraphConv``, ``NNConv``, ``GMMConv`` and ``CFConv``; the
sparse-matrix API (``sparse``, ``Graph.adj``), the graph queries,
constructors (``from_scipy``, ``rand_graph``, ...), structural transforms
(``add_self_loop``, ``to_bidirected``, ``to_block``, ...), subgraphs,
``batch`` and the readouts; the rest of the graph utilities (positional
encodings, kNN and radius graphs, shortest paths, diffusions, tag sorts,
the module transforms), ``traversal`` and ``propagate``, ``geometry``,
``nn.factory``, ``nn.glob``, ``models.GIN`` and ``models.Graphormer``;
the host samplers (``sampling``: neighbour, LABOR, random walks, negative
pairs, PinSAGE) and the rest of ``dataloading`` (the ragged and
heterogeneous samplers, edge prediction, the subgraph samplers, the
collators and the prefetching ``DataLoader``), and ``nn.DeepWalk`` and
``nn.MetaPath2Vec``; the multilevel partitioner and the per-part files
(``distributed``: ``metis_partition_assignment``, ``partition_graph``,
``load_partition``), graph files (``data.serialize``), the halo
partitions (``partition_graph_with_halo``, ``metis_partition``), the
METIS orders and ``ClusterGCNSampler``, and the explainers
(``nn.explain``: GNNExplainer, PGExplainer and SubgraphX, homogeneous and
heterogeneous); GraphBolt (``graphbolt``: the stage pipeline,
``FusedCSCSamplingGraph``, the feature stores and caches, the on-disk
dataset) and the lazy-feature markers; the dataset zoo (``data``: the
datasets, parsers, generators and adapters); the distributed layer
(``distributed``: shards and halo exchange, the sparse all-to-all, the
distributed samplers and loaders, ``DistTensor``, the KV store and the
graph services) over the meshes of ``parallel``; and the remainder: the
``dgl-tpu``-style trainer (``cli``: ``python -m dgl_tpu_torch``),
checkpoints in the JAX package's layout (``checkpoint``), graphs in
shared memory (``Graph.shared_memory``, ``hetero_from_shared_memory``,
``multiprocessing_mod``), the homophily measures, ``merge``, ``optim``,
``profiler``, ``health``, ``config``, ``random`` and ``utils``.
"""
from . import (data, dataloading, distributed, function, geometry, models,
               nn, ops, parallel, propagate, readout, sampling, sparse,
               transforms, traversal)
from . import subgraph as subgraph_module
from . import mpops, optim, storages, utils
from . import checkpoint, health
from . import random_mod as random
from .base import ALL, EID, ETYPE, NID, NTYPE, DGLError, DGLWarning
from .checkpoint import load_checkpoint, save_checkpoint
from .config import config, get_config
from .homophily import (adjusted_homophily, edge_homophily,
                        edge_label_informativeness, get_long_edges,
                        linkx_homophily, node_homophily,
                        node_label_informativeness)
from .logging_mod import enable_verbose_logging, get_logger
from .merge import merge
from .ops import edge_softmax
from .random_mod import seed
from .batch import batch, pad_batch, slice_batch, stack_graphs, unbatch
from .convert import (bipartite_from_networkx, bipartite_from_scipy,
                      block_to_graph, create_block, from_networkx,
                      from_scipy, graph, hetero_from_shared_memory,
                      heterograph, rand_bipartite, rand_graph,
                      to_heterogeneous, to_homogeneous, to_networkx)
from .data.serialize import load_graphs, save_graphs
from .distributed.partition import metis_partition_assignment
from .graph import Graph, Relation
from .partition_mod import (metis_partition, partition_graph_with_halo,
                            reshuffle_graph)
from .params import from_flax_params
from .readout import (broadcast_edges, broadcast_nodes, max_edges, max_nodes,
                      mean_edges, mean_nodes, readout_edges, readout_nodes,
                      softmax_edges, softmax_nodes, sum_edges, sum_nodes,
                      topk_edges, topk_nodes)
from .subgraph import (edge_subgraph, edge_type_subgraph, in_subgraph,
                       khop_in_subgraph, khop_out_subgraph, node_subgraph,
                       node_type_subgraph, out_subgraph)
from .propagate import (prop_edges, prop_edges_dfs, prop_nodes,
                        prop_nodes_bfs, prop_nodes_topo)
from .transforms.functional import (
    add_edges, add_nodes, add_reverse_edges, add_self_loop, adj_product_graph,
    adj_sum_graph, compact_graphs, double_radius_node_labeling,
    is_bidirected, khop_adj, khop_graph, knn, knn_graph,
    lap_pe, laplacian_lambda_max, laplacian_pe, line_graph,
    metapath_reachable_graph, metis_perm, norm_by_dst,
    pairwise_squared_distance, radius_graph, random_walk_pe, rcmk_perm,
    remove_edges, remove_nodes, remove_self_loop, reorder_graph, reverse,
    segmented_knn_graph, shortest_dist, sort_csc_by_tag, sort_csr_by_tag,
    svd_pe, to_bfloat16, to_bidirected, to_block, to_double, to_float,
    to_half, to_simple, to_simple_graph, update_graph_structure)

from . import graphbolt
from .graphbolt.lazy import (LazyFeature, set_dst_lazy_features,
                             set_edge_lazy_features, set_node_lazy_features,
                             set_src_lazy_features)

# `import dgl.function as fn`
fn = function

# the reference's names of the graph class
DGLGraph = Graph
DGLHeteroGraph = Graph


def apply_each(data, fn, *args, **kwargs):
    """Apply ``fn`` to every value of a dict (or to a bare value):
    reference ``dgl.apply_each`` (``python/dgl/utils/internal.py``)."""
    if isinstance(data, dict):
        return {k: fn(v, *args, **kwargs) for k, v in data.items()}
    return fn(data, *args, **kwargs)


__all__ = [
    "ALL", "EID", "ETYPE", "NID", "NTYPE", "DGLError", "DGLWarning", "Graph",
    "DGLGraph", "DGLHeteroGraph", "Relation",
    # message passing
    "fn", "edge_softmax", "apply_each",
    # construction
    "graph", "heterograph", "create_block", "from_scipy", "from_networkx",
    "to_networkx", "bipartite_from_scipy", "bipartite_from_networkx",
    "block_to_graph", "hetero_from_shared_memory", "to_homogeneous",
    "to_heterogeneous", "rand_graph", "rand_bipartite", "from_flax_params",
    # batching and readout
    "batch", "unbatch", "stack_graphs", "pad_batch", "slice_batch",
    "readout_nodes", "readout_edges", "sum_nodes", "mean_nodes",
    "max_nodes", "sum_edges", "mean_edges", "max_edges", "softmax_nodes",
    "softmax_edges", "broadcast_nodes", "broadcast_edges", "topk_nodes",
    "topk_edges",
    # subgraphs and structure
    "node_subgraph", "edge_subgraph", "in_subgraph", "out_subgraph",
    "khop_in_subgraph", "khop_out_subgraph", "node_type_subgraph",
    "edge_type_subgraph", "add_self_loop", "remove_self_loop",
    "add_reverse_edges", "add_edges", "remove_edges", "add_nodes",
    "remove_nodes", "to_bidirected", "to_simple", "to_simple_graph",
    "khop_adj", "khop_graph", "to_block", "reverse", "line_graph",
    "compact_graphs", "reorder_graph", "norm_by_dst", "is_bidirected",
    "update_graph_structure", "to_float", "to_double", "to_half",
    "to_bfloat16", "knn_graph", "segmented_knn_graph", "radius_graph",
    "knn", "pairwise_squared_distance", "laplacian_lambda_max",
    "random_walk_pe", "lap_pe", "laplacian_pe", "svd_pe", "shortest_dist",
    "double_radius_node_labeling", "metapath_reachable_graph",
    "adj_product_graph", "adj_sum_graph", "sort_csr_by_tag",
    "sort_csc_by_tag", "rcmk_perm", "metis_perm",
    # partitions and files
    "metis_partition_assignment", "partition_graph_with_halo",
    "metis_partition", "reshuffle_graph", "save_graphs", "load_graphs",
    # ordered propagation
    "prop_nodes", "prop_edges", "prop_nodes_bfs", "prop_nodes_topo",
    "prop_edges_dfs",
    # lazy features of the GraphBolt pipeline
    "LazyFeature", "set_node_lazy_features", "set_edge_lazy_features",
    "set_src_lazy_features", "set_dst_lazy_features",
    # graph measures and merging
    "node_homophily", "edge_homophily", "linkx_homophily",
    "adjusted_homophily", "edge_label_informativeness",
    "node_label_informativeness", "get_long_edges", "merge",
    # state
    "seed", "save_checkpoint", "load_checkpoint", "config", "get_config",
    "get_logger", "enable_verbose_logging",
    # namespaces
    "data", "dataloading", "distributed", "function", "geometry",
    "graphbolt", "models", "nn", "ops", "parallel",
    "propagate", "readout", "sampling", "sparse", "subgraph_module",
    "transforms", "traversal", "mpops", "optim", "storages", "utils",
    "random", "health", "checkpoint",
]
