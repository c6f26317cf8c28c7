"""Graph transforms (counterpart of ``dgl_tpu/transforms/``)."""
from .functional import reorder_for_spmm, reorder_graph

__all__ = ["reorder_for_spmm", "reorder_graph"]
