"""Builtin function base classes (reference ``python/dgl/function/base.py``)."""

class BuiltinFunction:
    """Base class of all builtin functions (reference ``function/base.py:8``)."""

    @property
    def name(self):
        raise NotImplementedError


class MessageFunction(BuiltinFunction):
    """Descriptor of a builtin message function.

    Mirrors ``python/dgl/function/message.py:31`` — carries (binary op,
    lhs target, rhs target, field names) so the core engine can pair it with
    a reducer and dispatch to a fused g-SpMM, or alone to g-SDDMM.
    """

    def __init__(self, binary_op, lhs, rhs, lhs_field, rhs_field, out_field):
        self.binary_op = binary_op  # add/sub/mul/div/dot or copy_lhs/copy_rhs
        self.lhs = lhs  # 'u' | 'v' | 'e' | None
        self.rhs = rhs
        self.lhs_field = lhs_field
        self.rhs_field = rhs_field
        self.out_field = out_field

    @property
    def name(self):
        if self.binary_op == "copy_lhs":
            return f"copy_{self.lhs}"
        return f"{self.lhs}_{self.binary_op}_{self.rhs}"

    def __repr__(self):
        return f"MessageFunction({self.name})"


class ReduceFunction(BuiltinFunction):
    """Descriptor of a builtin reduce function (``function/reducer.py:12``)."""

    def __init__(self, op, msg_field, out_field):
        self.op = op  # sum/max/min/mean/prod
        self.msg_field = msg_field
        self.out_field = out_field

    @property
    def name(self):
        return self.op

    def __repr__(self):
        return f"ReduceFunction({self.name})"
