"""Builtin message and reduce functions (reference ``python/dgl/function/``).

Descriptors only — the actual compute is lowered by ``dgl_tpu_torch.core`` to fused
g-SpMM / g-SDDMM ops, exactly like the reference pairs builtins to
``_CAPI_DGLKernelSpMM`` (``python/dgl/core.py:311``).
"""
from .message import *  # noqa: F401,F403
from .reducer import *  # noqa: F401,F403
from .message import __all__ as _msg_all
from .reducer import __all__ as _red_all

__all__ = list(_msg_all) + list(_red_all)
