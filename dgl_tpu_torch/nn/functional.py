"""nn.functional namespace (counterpart of ``dgl_tpu/nn/functional.py``;
reference ``python/dgl/nn/functional/``)."""
from ..ops.edge_softmax import edge_softmax

__all__ = ["edge_softmax"]
