"""Models composing the nn layers (counterpart of ``dgl_tpu/models/``)."""
from .gat import GAT
from .gcn import GCN
from .sage import GraphSAGE

__all__ = ["GAT", "GCN", "GraphSAGE"]
