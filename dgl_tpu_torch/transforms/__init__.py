"""Graph transforms (counterpart of ``dgl_tpu/transforms/``): the
functional transforms and their module forms."""
from . import functional, module  # noqa: F401
from .functional import *  # noqa: F401,F403
from .module import *  # noqa: F401,F403

__all__ = functional.__all__ + module.__all__
