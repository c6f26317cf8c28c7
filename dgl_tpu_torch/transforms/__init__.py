"""Graph transforms (counterpart of ``dgl_tpu/transforms/``)."""
from .functional import *  # noqa: F401,F403
from .functional import __all__
