"""Builtin message functions, generated combinatorially.

Mirrors ``python/dgl/function/message.py:124-190``: binary ops
{add, sub, mul, div, dot} x targets {u, v, e}, plus ``copy_u`` / ``copy_e``.
"""
import sys

from .base import MessageFunction

__all__ = ["copy_u", "copy_e"]

_BINARY_OPS = ["add", "sub", "mul", "div", "dot"]
_TARGETS = ["u", "v", "e"]


def copy_u(u, out):
    """Message = source node feature (reference ``message.py:63``)."""
    return MessageFunction("copy_lhs", "u", None, u, None, out)


def copy_e(e, out):
    """Message = edge feature (reference ``message.py:93``)."""
    return MessageFunction("copy_lhs", "e", None, e, None, out)


def _gen_message_builtin(lhs, rhs, binary_op):
    name = f"{lhs}_{binary_op}_{rhs}"

    def func(lhs_field, rhs_field, out):
        return MessageFunction(binary_op, lhs, rhs, lhs_field, rhs_field, out)

    func.__name__ = name
    func.__doc__ = (
        f"Message = {lhs}[{{lhs_field}}] {binary_op} {rhs}[{{rhs_field}}] "
        f"(generated like reference ``function/message.py:131``)."
    )
    return func


def _register_builtin_message_func():
    mod = sys.modules[__name__]
    for lhs in _TARGETS:
        for rhs in _TARGETS:
            if lhs == rhs:
                continue
            for op in _BINARY_OPS:
                func = _gen_message_builtin(lhs, rhs, op)
                setattr(mod, func.__name__, func)
                __all__.append(func.__name__)


_register_builtin_message_func()
