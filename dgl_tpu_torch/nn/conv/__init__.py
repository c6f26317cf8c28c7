"""Graph convolution layers (counterpart of ``dgl_tpu/nn/conv/``)."""
from .agnnconv import AGNNConv
from .atomicconv import AtomicConv
from .cfconv import CFConv, ShiftedSoftplus
from .dense import DenseChebConv, DenseGraphConv, DenseSAGEConv
from .dgnconv import DGNConv, DGNConvTower
from .dotgatconv import DotGatConv
from .edgeconv import EdgeConv
from .edgegatconv import EdgeGATConv
from .egatconv import EGATConv
from .egnnconv import EGNNConv
from .gatconv import GATConv
from .gatedgcnconv import GatedGCNConv
from .gatedgraphconv import GatedGraphConv
from .gatv2conv import GATv2Conv
from .gcn2conv import GCN2Conv
from .ginconv import GINConv
from .gineconv import GINEConv
from .gmmconv import GMMConv
from .graphconv import (GraphConv, check_zero_in_degree, expand_as_pair,
                        precompute_graphconv)
from .grouprevres import GroupRevRes
from .hgtconv import HGTConv
from .nnconv import NNConv
from .pnaconv import PNAConv, PNAConvTower
from .relgraphconv import RelGraphConv
from .sageconv import SAGEConv
from .spectral import APPNPConv, ChebConv, SGConv, TAGConv
from .twirlsconv import TWIRLSConv, TWIRLSUnfoldingAndAttention

__all__ = ["AGNNConv", "APPNPConv", "AtomicConv", "CFConv", "ChebConv",
           "DGNConv", "DenseChebConv", "DenseGraphConv", "DenseSAGEConv",
           "DotGatConv", "EGATConv", "EGNNConv", "EdgeConv", "EdgeGATConv",
           "GATConv", "GATv2Conv", "GCN2Conv", "GINConv", "GINEConv",
           "GMMConv", "GatedGCNConv", "GatedGraphConv", "GraphConv",
           "GroupRevRes", "HGTConv", "NNConv", "PNAConv", "RelGraphConv",
           "SAGEConv", "SGConv", "ShiftedSoftplus", "TAGConv", "TWIRLSConv",
           "TWIRLSUnfoldingAndAttention", "check_zero_in_degree",
           "expand_as_pair", "precompute_graphconv"]
