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
``GatedGraphConv``, ``NNConv``, ``GMMConv`` and ``CFConv``.
"""
from . import dataloading, function, models, nn, ops, sampling, transforms
from .base import ALL, EID, ETYPE, NID, NTYPE, DGLError
from .convert import (create_block, graph, heterograph, to_heterogeneous,
                      to_homogeneous)
from .graph import Graph, Relation
from .params import from_flax_params

__all__ = ["ALL", "EID", "ETYPE", "NID", "NTYPE", "DGLError", "Graph",
           "Relation", "create_block", "dataloading", "function",
           "from_flax_params", "graph", "heterograph", "models", "nn", "ops",
           "sampling", "to_heterogeneous", "to_homogeneous", "transforms"]
