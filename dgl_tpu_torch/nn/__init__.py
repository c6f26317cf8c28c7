"""GNN layers (counterpart of ``dgl_tpu/nn/``), as ``torch.nn`` modules."""
from .conv import *  # noqa: F401,F403
from .hetero import HeteroGraphConv  # noqa: F401
from .linear import (HeteroEmbedding, HeteroLinear, TypedLinear,  # noqa: F401
                     bmm_maybe_select, matmul_maybe_select)
from .utils_nn import EdgeWeightNorm  # noqa: F401
