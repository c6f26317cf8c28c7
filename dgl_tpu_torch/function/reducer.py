"""Builtin reduce functions (reference ``python/dgl/function/reducer.py``)."""
import sys

from .base import ReduceFunction

__all__ = []

_REDUCE_OPS = ["sum", "max", "min", "mean", "prod"]


def _gen_reduce_builtin(op):
    def func(msg, out):
        return ReduceFunction(op, msg, out)

    func.__name__ = op
    func.__doc__ = (
        f"Aggregate messages by {op} (generated like reference "
        f"``function/reducer.py:84``)."
    )
    return func


def _register_builtin_reduce_func():
    mod = sys.modules[__name__]
    for op in _REDUCE_OPS:
        func = _gen_reduce_builtin(op)
        setattr(mod, func.__name__, func)
        __all__.append(op)


_register_builtin_reduce_func()
