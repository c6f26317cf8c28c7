"""Message-passing engine (counterpart of ``dgl_tpu/core.py``).

A builtin message paired with a builtin reducer lowers to one fused g-SpMM
(reference ``python/dgl/core.py:311``). This slice ports that pairing for
the messages g-SpMM takes directly (``copy_u``, ``copy_e`` and the
``u op e`` binaries) with the sum/mean reducers; user-defined functions and
the g-SDDMM lowering come in a later slice.
"""
from __future__ import annotations

from . import ops
from .base import DGLError
from .function.base import MessageFunction, ReduceFunction
from .graph import Graph

__all__ = ["message_passing", "invoke_gspmm"]


def _fetch(g: Graph, cet, target: str, field: str):
    if target == "u":
        frame = g._node_frames.setdefault(cet[0], {})
    elif target == "e":
        frame = g._edge_frames.setdefault(cet, {})
    else:
        raise NotImplementedError(
            f"messages reading the {target!r} frame lower to g-SDDMM: "
            "ROADMAP queue A2")
    if field not in frame:
        raise DGLError(f"Field {field!r} not found in {target}-frame of {cet}")
    return frame[field]


def invoke_gspmm(g: Graph, cet, mfunc: MessageFunction,
                 rfunc: ReduceFunction):
    """Fused message+reduce (reference ``core.py:311``)."""
    rel = g._relations[cet]
    reduce_op = rfunc.name
    if mfunc.binary_op == "copy_lhs":
        if mfunc.lhs == "u":
            x = _fetch(g, cet, "u", mfunc.lhs_field)
            out = ops.gspmm(rel, "copy_lhs", reduce_op, x, None)
        elif mfunc.lhs == "e":
            x = _fetch(g, cet, "e", mfunc.lhs_field)
            out = ops.gspmm(rel, "copy_rhs", reduce_op, None, x)
        else:
            raise DGLError("copy_v message is not meaningful for update_all")
        return {rfunc.out_field: out}
    if (mfunc.lhs, mfunc.rhs) != ("u", "e") or mfunc.binary_op == "dot":
        raise NotImplementedError(
            f"message {mfunc.name}: lowers through g-SDDMM, ROADMAP queue A2")
    u = _fetch(g, cet, "u", mfunc.lhs_field)
    e = _fetch(g, cet, "e", mfunc.rhs_field)
    out = ops.gspmm(rel, mfunc.binary_op, reduce_op, u, e)
    return {rfunc.out_field: out}


def message_passing(g: Graph, mfunc, rfunc, afunc=None, etype=None):
    """Core dispatch (reference ``python/dgl/core.py:372``). Returns the new
    dst-node fields as a dict."""
    if not (isinstance(mfunc, MessageFunction)
            and isinstance(rfunc, ReduceFunction)) or afunc is not None:
        raise NotImplementedError(
            "user-defined message/reduce/apply functions: ROADMAP queue A2")
    return invoke_gspmm(g, g.to_canonical_etype(etype), mfunc, rfunc)


def update_all_(g: Graph, message_func, reduce_func, apply_node_func=None,
                etype=None):
    """``DGLGraph.update_all`` (reference ``heterograph.py:5018``)."""
    cet = g.to_canonical_etype(etype)
    ndata = message_passing(g, message_func, reduce_func, apply_node_func,
                            etype=cet)
    g._node_frames.setdefault(cet[2], {}).update(ndata)
    return ndata
