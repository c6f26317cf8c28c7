"""Explainability (counterpart of ``dgl_tpu/nn/explain/``; reference
``python/dgl/nn/pytorch/explain/``)."""
from .gnnexplainer import GNNExplainer
from .hetero_gnnexplainer import HeteroGNNExplainer
from .hetero_pgexplainer import HeteroPGExplainer
from .hetero_subgraphx import HeteroSubgraphX
from .pgexplainer import PGExplainer
from .subgraphx import SubgraphX

__all__ = [
    "GNNExplainer",
    "HeteroGNNExplainer",
    "PGExplainer",
    "HeteroPGExplainer",
    "SubgraphX",
    "HeteroSubgraphX",
]
