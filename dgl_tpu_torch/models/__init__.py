"""Models composing the nn layers (counterpart of ``dgl_tpu/models/``)."""
from .sage import GraphSAGE

__all__ = ["GraphSAGE"]
