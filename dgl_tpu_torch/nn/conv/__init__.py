"""Graph convolution layers (counterpart of ``dgl_tpu/nn/conv/``)."""
from .agnnconv import AGNNConv
from .cfconv import CFConv, ShiftedSoftplus
from .dotgatconv import DotGatConv
from .edgeconv import EdgeConv
from .edgegatconv import EdgeGATConv
from .egatconv import EGATConv
from .gatconv import GATConv
from .gatedgraphconv import GatedGraphConv
from .gatv2conv import GATv2Conv
from .gcn2conv import GCN2Conv
from .ginconv import GINConv
from .gineconv import GINEConv
from .gmmconv import GMMConv
from .graphconv import (GraphConv, check_zero_in_degree, expand_as_pair,
                        precompute_graphconv)
from .hgtconv import HGTConv
from .nnconv import NNConv
from .relgraphconv import RelGraphConv
from .sageconv import SAGEConv
from .spectral import APPNPConv, ChebConv, SGConv, TAGConv

__all__ = ["AGNNConv", "APPNPConv", "CFConv", "ChebConv", "DotGatConv",
           "EGATConv", "EdgeConv", "EdgeGATConv", "GATConv", "GATv2Conv",
           "GCN2Conv", "GINConv", "GINEConv", "GMMConv", "GatedGraphConv",
           "GraphConv", "HGTConv", "NNConv", "RelGraphConv", "SAGEConv",
           "SGConv", "ShiftedSoftplus", "TAGConv", "check_zero_in_degree",
           "expand_as_pair", "precompute_graphconv"]
