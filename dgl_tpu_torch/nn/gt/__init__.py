"""Graph transformer building blocks (counterpart of ``dgl_tpu/nn/gt/``;
reference ``python/dgl/nn/pytorch/gt/``).

They work on dense padded batches (B, N, ...): attention over all node
pairs with structural biases, as ``torch.matmul`` products (the reference
has no hand kernel here).
"""
from .biased_mha import BiasedMHA
from .degree_encoder import DegreeEncoder
from .egt import EGTLayer
from .graphormer import GraphormerLayer
from .lap_pos_encoder import LapPosEncoder
from .path_encoder import PathEncoder
from .spatial_encoder import SpatialEncoder, SpatialEncoder3d, gaussian

__all__ = [
    "DegreeEncoder",
    "LapPosEncoder",
    "PathEncoder",
    "SpatialEncoder",
    "SpatialEncoder3d",
    "BiasedMHA",
    "GraphormerLayer",
    "EGTLayer",
    "gaussian",
]
