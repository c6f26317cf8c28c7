"""Models composing the nn layers (counterpart of ``dgl_tpu/models/``)."""
from .device_sage import DeviceSAGE
from .gat import GAT
from .gcn import GCN
from .gin import GIN
from .graphormer import Graphormer, prepare_batch
from .rgcn import RGCN
from .sage import GraphSAGE

__all__ = ["DeviceSAGE", "GAT", "GCN", "GIN", "Graphormer", "GraphSAGE",
           "RGCN", "prepare_batch"]
