"""Graph convolution layers (counterpart of ``dgl_tpu/nn/conv/``)."""
from .graphconv import expand_as_pair
from .sageconv import SAGEConv

__all__ = ["SAGEConv", "expand_as_pair"]
