"""GNN layers (counterpart of ``dgl_tpu/nn/``), as ``torch.nn`` modules."""
from . import explain, functional, gt  # noqa: F401
from .conv import *  # noqa: F401,F403
from .conv.atomicconv import RadialPooling, msg_func, reduce_func  # noqa: F401
from .conv.dgnconv import DGNConvTower  # noqa: F401
from .conv.grouprevres import InvertibleCheckpoint  # noqa: F401
from .conv.pna_helpers import (  # noqa: F401
    aggregate_dir_av, aggregate_dir_dx, aggregate_max, aggregate_mean,
    aggregate_min, aggregate_moment_3, aggregate_moment_4,
    aggregate_moment_5, aggregate_std, aggregate_sum, aggregate_var,
    get_aggregate_fn, scale_amplification, scale_attenuation,
    scale_identity)
from .conv.pnaconv import PNAConvTower  # noqa: F401
from .factory import KNNGraph, RadiusGraph, SegmentedKNNGraph  # noqa: F401
from .glob import *  # noqa: F401,F403
from .explain import *  # noqa: F401,F403
from .explain.subgraphx import MCTSNode  # noqa: F401
from .conv.twirlsconv import (AX, MLP, Attention, D_power_bias_X,  # noqa: F401
                              D_power_X, Propagate, PropagateNoPrecond,
                              normalized_AX)
from .gt import *  # noqa: F401,F403
from .hetero import HeteroGraphConv  # noqa: F401
from .link import EdgePredictor, TransE, TransR  # noqa: F401
from .network_emb import DeepWalk, MetaPath2Vec  # noqa: F401
from .linear import (HeteroEmbedding, HeteroLinear, TypedLinear,  # noqa: F401
                     bmm_maybe_select, matmul_maybe_select)
from .sparse_emb import (NodeEmbedding, sparse_adagrad_init,  # noqa: F401
                         sparse_adagrad_update, sparse_adam_init,
                         sparse_adam_update)
from .utils_nn import (EdgeWeightNorm, Identity,  # noqa: F401
                       JumpingKnowledge, LabelPropagation, Sequential,
                       WeightBasis)
