"""Graph convolution layers (counterpart of ``dgl_tpu/nn/conv/``)."""
from .gatconv import GATConv
from .graphconv import (GraphConv, check_zero_in_degree, expand_as_pair,
                        precompute_graphconv)
from .relgraphconv import RelGraphConv
from .sageconv import SAGEConv

__all__ = ["GATConv", "GraphConv", "RelGraphConv", "SAGEConv",
           "check_zero_in_degree", "expand_as_pair", "precompute_graphconv"]
