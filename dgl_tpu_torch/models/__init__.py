"""Models composing the nn layers (counterpart of ``dgl_tpu/models/``)."""
from .device_sage import DeviceSAGE
from .gat import GAT
from .gcn import GCN
from .rgcn import RGCN
from .sage import GraphSAGE

__all__ = ["DeviceSAGE", "GAT", "GCN", "GraphSAGE", "RGCN"]
