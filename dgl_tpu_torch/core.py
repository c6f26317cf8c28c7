"""Message-passing engine (counterpart of ``dgl_tpu/core.py``; reference
``python/dgl/core.py``).

``message_passing`` dispatches as the reference does (``core.py:372``):

1. a builtin message with a builtin reducer lowers to one g-SpMM
   (``invoke_gspmm``, reference ``core.py:311``); messages that read ``v``,
   ``dot`` messages and ``e sub/div u`` are materialised per edge with
   g-SDDMM first and reduced as ``copy_e``;
2. a builtin message alone (``apply_edges``) lowers to g-SDDMM
   (``invoke_gsddmm``, reference ``core.py:273``);
3. a UDF message or reducer materialises the messages per edge; a UDF
   reducer then reads one padded mailbox (``invoke_udf_reduce``) in place
   of the reference's degree buckets, as ``dgl_tpu`` does.

``multi_update_all`` runs each relation's update and combines the results
per destination type with a cross reducer. ``pull`` runs the full fused
reduce and writes only the rows asked for; ``send_and_recv`` (and ``push``,
over a node's out-edges) materialises the messages, keeps the edge subset
and reduces it by destination, as ``dgl_tpu`` does.
"""
from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from . import ops
from .base import ALL, DGLError, is_all
from .function.base import MessageFunction, ReduceFunction
from .graph import Graph, _asnumpy
from .ops.sddmm import _gather_target
from .udf import EdgeBatch, NodeBatch

__all__ = ["message_passing", "invoke_gspmm", "invoke_gsddmm",
           "invoke_edge_udf", "invoke_udf_reduce", "pull", "push",
           "send_and_recv"]


def _src_frame(g: Graph, cet):
    return g._node_frames.setdefault(cet[0], {})


def _dst_frame(g: Graph, cet):
    """The destination nodes' frame: a block's own, a graph's node
    frame."""
    return g._dst_frames.setdefault(cet[2], {})


def _edge_frame(g: Graph, cet):
    return g._edge_frames.setdefault(cet, {})


def _fetch(g: Graph, cet, target: str, field: str):
    if target == "u":
        frame = _src_frame(g, cet)
    elif target == "v":
        frame = _dst_frame(g, cet)
    elif target == "e":
        frame = _edge_frame(g, cet)
    else:
        raise DGLError(f"Unknown target {target!r}")
    if field not in frame:
        raise DGLError(f"Field {field!r} not found in {target}-frame of {cet}")
    return frame[field]


def invoke_gsddmm(g: Graph, cet, mfunc: MessageFunction):
    """Per-edge messages with g-SDDMM (reference ``core.py:273``)."""
    rel = g._relations[cet]
    lhs = _fetch(g, cet, mfunc.lhs, mfunc.lhs_field)
    if mfunc.binary_op == "copy_lhs":
        out = ops.gsddmm(rel, "copy_lhs", lhs, None, lhs_target=mfunc.lhs)
    else:
        rhs = _fetch(g, cet, mfunc.rhs, mfunc.rhs_field)
        out = ops.gsddmm(rel, mfunc.binary_op, lhs, rhs,
                         lhs_target=mfunc.lhs, rhs_target=mfunc.rhs)
    return {mfunc.out_field: out}


def invoke_gspmm(g: Graph, cet, mfunc: MessageFunction,
                 rfunc: ReduceFunction):
    """Fused message + reduce (reference ``core.py:311``)."""
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
    op = mfunc.binary_op
    if {mfunc.lhs, mfunc.rhs} == {"u", "e"} and op != "dot" and not (
            mfunc.lhs == "e" and op in ("sub", "div")):
        # u op e, or the commuting e add/mul u: g-SpMM takes (u, e)
        u_field, e_field = ((mfunc.lhs_field, mfunc.rhs_field)
                            if mfunc.lhs == "u"
                            else (mfunc.rhs_field, mfunc.lhs_field))
        u = _fetch(g, cet, "u", u_field)
        e = _fetch(g, cet, "e", e_field)
        return {rfunc.out_field: ops.gspmm(rel, op, reduce_op, u, e)}
    # e sub/div u, dot, and messages reading v: materialise, reduce copy_e
    msg = invoke_gsddmm(g, cet, mfunc)[mfunc.out_field]
    out = ops.gspmm(rel, "copy_rhs", reduce_op, None, msg)
    return {rfunc.out_field: out}


def invoke_edge_udf(g: Graph, cet, func: Callable):
    """Run an edge UDF over all edges (reference ``core.py:52``)."""
    rel = g._relations[cet]
    src_data = {k: _gather_target(rel, "u", v)
                for k, v in _src_frame(g, cet).items()}
    dst_data = {k: _gather_target(rel, "v", v)
                for k, v in _dst_frame(g, cet).items()}
    ebatch = EdgeBatch(src_data, dict(_edge_frame(g, cet)), dst_data,
                       edges=(rel.src, rel.dst))
    out = func(ebatch)
    if not isinstance(out, dict):
        raise DGLError("Edge UDF must return a dict of edge fields")
    return out


def invoke_node_udf(g: Graph, func: Callable, ntype: str, orig=None):
    """Run a node UDF over the destination nodes (a graph's nodes)."""
    data = dict(g._dst_frames.setdefault(ntype, {}))
    if orig:
        data.update(orig)
    out = func(NodeBatch(data))
    if not isinstance(out, dict):
        raise DGLError("Node UDF must return a dict of node fields")
    return out


def invoke_udf_reduce(g: Graph, cet, rfunc: Callable, msgdata: Dict):
    """Padded-mailbox UDF reduce (``dgl_tpu`` ``core.py:147``).

    Slot ``r`` of node ``d``'s (max_in_degree, feat) mailbox holds its
    r-th incoming message in CSC order; the rest are zeros, and the
    ``NodeBatch``'s ``mailbox_mask`` marks the real slots. The UDF sees all
    destinations at once."""
    rel = g._relations[cet]
    maxdeg = max(rel.max_in_degree, 1)
    n, E = rel.num_dst, rel.num_edges
    dst = rel.csc_dst[:E].to(torch.int64)
    # rank of each sorted edge within its destination's segment
    rank = torch.arange(E, device=dst.device) - rel.csc_indptr[dst]
    slot = dst * maxdeg + rank
    mailbox = {}
    for k, v in msgdata.items():
        vs = v.index_select(0, rel.csc_eids[:E])
        buf = vs.new_zeros((n * maxdeg,) + tuple(vs.shape[1:]))
        # in place: the zero buffer is the mailbox (no second copy)
        buf.index_copy_(0, slot, vs)
        mailbox[k] = buf.reshape((n, maxdeg) + tuple(vs.shape[1:]))
    deg = rel.in_degrees()
    mask = (torch.arange(maxdeg, device=deg.device)[None, :]
            < deg[:, None])
    out = rfunc(NodeBatch(dict(_dst_frame(g, cet)), mailbox, mask))
    if not isinstance(out, dict):
        raise DGLError("Reduce UDF must return a dict of node fields")
    return out


def message_passing(g: Graph, mfunc, rfunc, afunc=None, etype=None):
    """Core dispatch (reference ``python/dgl/core.py:372``). Returns the new
    dst-node fields as a dict."""
    cet = g.to_canonical_etype(etype)
    if isinstance(mfunc, MessageFunction) and isinstance(rfunc,
                                                         ReduceFunction):
        ndata = invoke_gspmm(g, cet, mfunc, rfunc)
    else:
        if isinstance(mfunc, MessageFunction):
            msgdata = invoke_gsddmm(g, cet, mfunc)
        else:
            msgdata = invoke_edge_udf(g, cet, mfunc)
        if isinstance(rfunc, ReduceFunction):
            out = ops.gspmm(g._relations[cet], "copy_rhs", rfunc.name, None,
                            msgdata[rfunc.msg_field])
            ndata = {rfunc.out_field: out}
        else:
            ndata = invoke_udf_reduce(g, cet, rfunc, msgdata)
    if afunc is not None:
        data = dict(_dst_frame(g, cet))
        data.update(ndata)
        ndata.update(afunc(NodeBatch(data)))
    return ndata


# ---------------------------------------------------------------------------
# Graph-method implementations (bound in graph.py)
# ---------------------------------------------------------------------------


def update_all_(g: Graph, message_func, reduce_func, apply_node_func=None,
                etype=None):
    """``DGLGraph.update_all`` (reference ``heterograph.py:5018``)."""
    cet = g.to_canonical_etype(etype)
    ndata = message_passing(g, message_func, reduce_func, apply_node_func,
                            etype=cet)
    _dst_frame(g, cet).update(ndata)
    return ndata


def _set_rows(frame, data, rows):
    """Write ``data[k][rows]`` into ``frame[k]`` out of place (zeros where
    the frame has no such field of that shape); returns the rows."""
    for k, val in data.items():
        base = frame.get(k)
        if base is None or base.shape != val.shape:
            base = torch.zeros_like(val)
        frame[k] = base.index_put((rows,), val[rows])
    return {k: v[rows] for k, v in data.items()}


def _ids(ids, device):
    return torch.atleast_1d(torch.as_tensor(ids, device=device)).to(
        torch.int64)


def apply_edges_(g: Graph, func, edges=ALL, etype=None):
    """``DGLGraph.apply_edges`` (reference ``heterograph.py:4597``).

    A subset is computed over all edges and only its rows are written into
    the edge frame, as ``dgl_tpu`` does; the subset's values are
    returned."""
    cet = g.to_canonical_etype(etype)
    if isinstance(func, MessageFunction):
        edata = invoke_gsddmm(g, cet, func)
    else:
        edata = invoke_edge_udf(g, cet, func)
    frame = _edge_frame(g, cet)
    if is_all(edges):
        frame.update(edata)
        return edata
    return _set_rows(frame, edata, _ids(edges, g.device))


def apply_nodes(g: Graph, func, v=ALL, ntype=None):
    """``DGLGraph.apply_nodes`` (reference ``heterograph.py:4495``); a node
    subset is computed over all nodes and its rows written. On a block it
    runs over the destination nodes, as the reference's does."""
    if ntype is None:
        if len(g.ntypes) != 1:
            raise DGLError("ntype required for graphs with multiple node "
                           "types")
        ntype = g.ntypes[0]
    ndata = invoke_node_udf(g, func, ntype)
    frame = g._dst_frames.setdefault(ntype, {})
    if is_all(v):
        frame.update(ndata)
        return ndata
    return _set_rows(frame, ndata, _ids(v, g.device))


# how per-relation results combine per destination type:
# multi_update_all's cross reducers, HeteroGraphConv's aggregates
CROSS_REDUCERS = {
    "sum": lambda xs: sum(xs[1:], xs[0]),
    "max": lambda xs: torch.stack(xs).amax(0),
    "min": lambda xs: torch.stack(xs).amin(0),
    "mean": lambda xs: torch.stack(xs).mean(0),
    "stack": lambda xs: torch.stack(xs, 1),
}


def _cross_reduce(vals, cross_reducer):
    """Combine one field's per-relation results (reference
    ``core.py:304-318``); a single result passes through unless the
    reducer is ``stack``."""
    if cross_reducer not in CROSS_REDUCERS:
        raise DGLError(f"Unknown cross reducer {cross_reducer!r}")
    if len(vals) == 1 and cross_reducer != "stack":
        return vals[0]
    return CROSS_REDUCERS[cross_reducer](vals)


def multi_update_all_(g: Graph, etype_dict, cross_reducer,
                      apply_node_func=None):
    """``DGLGraph.multi_update_all`` (reference ``heterograph.py:5161``;
    ``dgl_tpu/core.py:278-320``).

    ``etype_dict``: etype -> ``(message, reduce[, apply])``. Each
    relation's results are combined per destination type and field with
    ``cross_reducer`` in {sum, max, min, mean, stack} and written into
    that type's frame; returns them as lists by type and field."""
    per_dst: Dict[str, Dict[str, list]] = {}
    for etype, spec in etype_dict.items():
        cet = g.to_canonical_etype(etype)
        afunc = spec[2] if len(spec) > 2 else None
        ndata = message_passing(g, spec[0], spec[1], afunc, etype=cet)
        store = per_dst.setdefault(cet[2], {})
        for k, v in ndata.items():
            store.setdefault(k, []).append(v)
    for dsttype, fields in per_dst.items():
        frame = g._dst_frames.setdefault(dsttype, {})
        for k, vals in fields.items():
            frame[k] = _cross_reduce(vals, cross_reducer)
    if apply_node_func is not None:
        for dsttype in per_dst:
            apply_nodes(g, apply_node_func, ntype=dsttype)
    return per_dst


def _write_rows(frame, data, rows):
    """Write ``data``'s ``rows`` into ``frame``'s fields of the same shape
    out of place; a field the frame lacks (or holds in another shape)
    takes the whole value, as the reference's subset updates do."""
    for k, val in data.items():
        base = frame.get(k)
        if base is not None and base.shape == val.shape:
            frame[k] = base.index_put((rows,), val[rows])
        else:
            frame[k] = val


def pull(g: Graph, v, message_func, reduce_func, apply_node_func=None,
         etype=None):
    """``DGLGraph.pull`` (reference ``heterograph.py:5400``;
    ``dgl_tpu/core.py:329-354``): the full fused reduce over the relation,
    of which only the rows ``v`` are written (``apply_node_func`` runs over
    every destination and its ``v`` rows are written too). Returns the
    full reduce."""
    cet = g.to_canonical_etype(etype)
    ndata = message_passing(g, message_func, reduce_func, None, etype=cet)
    rows = _ids(v, g.device)
    dstf = _dst_frame(g, cet)
    _write_rows(dstf, ndata, rows)
    if apply_node_func is not None:
        _write_rows(dstf, apply_node_func(NodeBatch(dict(dstf))), rows)
    return ndata


def _np_ids(ids) -> np.ndarray:
    return _asnumpy(ids).astype(np.int64)


def _subset_udf_reduce(g: Graph, cet, eids: np.ndarray, rfunc, msgdata):
    """The padded-mailbox UDF reduce over an edge subset: slot ``r`` of
    node ``d`` holds the subset's r-th edge into ``d`` in the subset's
    order, the slots laid out on the host from the subset sorted by
    destination (reference ``core.py:382-413``). Returns the UDF's output
    and the destinations the subset reaches."""
    rel = g._relations[cet]
    dst_np = rel.host_arrays("dst")[0][eids].astype(np.int64)
    order = np.argsort(dst_np, kind="stable")
    eids_sorted, dst_sorted = eids[order], dst_np[order]
    n = rel.num_dst
    deg = np.bincount(dst_sorted, minlength=n)
    maxdeg = max(int(deg.max()) if deg.size else 0, 1)
    cum = np.concatenate(([0], np.cumsum(deg)))
    rank = np.arange(eids.shape[0]) - cum[dst_sorted]
    dev = g.device
    slot = torch.from_numpy(dst_sorted * maxdeg + rank).to(dev)
    picked = torch.from_numpy(eids_sorted).to(dev)
    mailbox = {}
    for k, m in msgdata.items():
        vs = m.index_select(0, picked)
        buf = vs.new_zeros((n * maxdeg,) + tuple(vs.shape[1:]))
        mailbox[k] = buf.index_copy(0, slot, vs).reshape(
            (n, maxdeg) + tuple(vs.shape[1:]))
    mask = (torch.arange(maxdeg, device=dev)[None, :]
            < torch.from_numpy(deg).to(dev)[:, None])
    out = rfunc(NodeBatch(dict(_dst_frame(g, cet)), mailbox, mask))
    if not isinstance(out, dict):
        raise DGLError("Reduce UDF must return a dict of node fields")
    return out, np.unique(dst_sorted)


def _subset_reduce(name: str, msg, dst, n: int):
    """A builtin reducer over the subset's messages ``msg`` by destination
    ``dst`` (reference ``core.py:414-429``): sum, mean (over the subset's
    in-edges), max or min, the last two 0 wherever the result is not
    finite (a destination the subset does not reach, and an infinite
    message)."""
    shape = (n,) + tuple(msg.shape[1:])
    idx = dst.reshape((-1,) + (1,) * (msg.dim() - 1))
    if name in ("sum", "mean"):
        out = msg.new_zeros(shape).index_add(0, dst, msg)
        if name == "mean":
            cnt = torch.bincount(dst, minlength=n).to(msg.dtype)
            out = out / torch.clamp(cnt, min=1).reshape(
                (n,) + (1,) * (msg.dim() - 1))
        return out
    if name not in ("max", "min"):
        raise DGLError(f"Unknown reduce {name!r}")
    fill = -torch.inf if name == "max" else torch.inf
    out = msg.new_full(shape, fill).scatter_reduce(
        0, idx.expand_as(msg), msg, "amax" if name == "max" else "amin")
    return torch.where(torch.isfinite(out), out, 0)


def send_and_recv(g: Graph, edges, message_func, reduce_func,
                  apply_node_func=None, etype=None):
    """``DGLGraph.send_and_recv`` (reference ``heterograph.py:5230``;
    ``dgl_tpu/core.py:357-445``): the messages of every edge, of which the
    edges ``edges`` (host ids) are reduced by destination; only the
    destinations they reach are written (a field the frame lacks takes the
    whole result). Returns the reduce's fields."""
    cet = g.to_canonical_etype(etype)
    rel = g._relations[cet]
    if isinstance(message_func, MessageFunction):
        msgdata = invoke_gsddmm(g, cet, message_func)
    else:
        msgdata = invoke_edge_udf(g, cet, message_func)
    eids = np.atleast_1d(_np_ids(edges))
    if isinstance(reduce_func, ReduceFunction):
        picked = torch.from_numpy(eids).to(g.device)
        dst = rel.dst.index_select(0, picked).to(torch.int64)
        out = {reduce_func.out_field: _subset_reduce(
            reduce_func.name,
            msgdata[reduce_func.msg_field].index_select(0, picked), dst,
            rel.num_dst)}
        touched = np.unique(rel.host_arrays("dst")[0][eids])
    else:
        out, touched = _subset_udf_reduce(g, cet, eids, reduce_func, msgdata)
    rows = torch.from_numpy(touched.astype(np.int64)).to(g.device)
    dstf = _dst_frame(g, cet)
    _write_rows(dstf, out, rows)
    if apply_node_func is not None:
        _write_rows(dstf, apply_node_func(NodeBatch(dict(dstf))), rows)
    return out


def push(g: Graph, u, message_func, reduce_func, apply_node_func=None,
         etype=None):
    """``DGLGraph.push`` (reference ``heterograph.py:5330``;
    ``dgl_tpu/core.py:448-459``): ``send_and_recv`` over the out-edges of
    the nodes ``u``, taken from the CSR's edge ids."""
    rel = g._relation(etype)
    indptr, csr_eids = rel.host_arrays("csr_indptr", "csr_eids")
    u_np = np.atleast_1d(_np_ids(u))
    eids = (np.concatenate([csr_eids[indptr[i]:indptr[i + 1]] for i in u_np])
            if u_np.size else np.zeros(0, np.int64))
    return send_and_recv(g, eids, message_func, reduce_func,
                         apply_node_func, etype=etype)
