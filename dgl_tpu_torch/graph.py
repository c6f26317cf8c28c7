"""Graph object of the port (counterpart of ``dgl_tpu/graph.py``).

A :class:`Relation` holds one canonical edge type as COO + CSR + CSC index
tensors, built once on the host with numpy and moved to the graph's device.
Padded edges (beyond ``num_edges``) point at the virtual rows
``num_src``/``num_dst``, as in the reference. A :class:`Graph` maps
canonical edge types to relations and keeps node and edge features in plain
dicts, one per type, behind ``ndata``/``srcdata``/``dstdata``/``edata``
views (``nodes[ntype].data`` and ``edges_view[etype].data`` for one type of
several).

Ported: graphs of any number of node and edge types, and the
message-flow-graph block (``is_block=True``, reference ``create_block``),
whose destination nodes have frames of their own and may be of other types
than its sources.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from .base import ALL, DGLError, is_all

CanonicalEtype = Tuple[str, str, str]


def _asnumpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _np_idtype(idtype) -> np.dtype:
    if idtype == torch.int32:
        return np.dtype(np.int32)
    if idtype == torch.int64:
        return np.dtype(np.int64)
    raise DGLError(f"idtype must be torch.int32 or torch.int64, got {idtype}")


_HASH_P = 2 ** 31 - 1  # a prime: every product below stays under 2^63


def _hash_keys(keys: torch.Tensor) -> int:
    """Sum over distinct int64 keys of a squared affine hash mod
    ``_HASH_P``: independent of order and device, and no integer overflow
    for keys below 2^62 and fewer than 2^32 of them."""
    lo, hi = keys % _HASH_P, keys // _HASH_P
    a = (lo * 1_103_515_245 + hi * 12_345 + 1) % _HASH_P
    return int(((a * a) % _HASH_P).sum())


# ---------------------------------------------------------------------------
# Relation structure (one canonical edge type)
# ---------------------------------------------------------------------------


class Relation:
    """Adjacency of one canonical edge type in COO + CSR + CSC.

    - ``src``, ``dst``: COO endpoints in edge-ID order.
    - ``csr_*``: out-edges grouped by source row.
    - ``csc_*``: in-edges grouped by destination row, the layout g-SpMM
      consumes; ``csc_dst`` is the sorted per-edge destination id.
    """

    ARRAY_FIELDS = (
        "src",
        "dst",
        "csr_indptr",
        "csr_indices",
        "csr_eids",
        "csr_src",
        "csc_indptr",
        "csc_indices",
        "csc_eids",
        "csc_dst",
    )

    # plans (ops.gspmm, ops.edge_softmax and GATConv dispatch on them)
    hub_plan = None
    shell_plan = None
    bitmap_plan = None
    dense_adj = None
    # > 0 on a fixed-shape MFG block: edge d*f+j belongs to dst d or to the
    # padding sink, so reductions are a masked reshape (ops/spmm.py)
    uniform_stride = 0

    def __init__(self, arrays: Mapping[str, torch.Tensor], *, num_src: int,
                 num_dst: int, num_edges: int, max_in_degree: int = -1,
                 max_out_degree: int = -1, min_in_degree: int = -1,
                 min_out_degree: int = -1, hub_plan=None):
        for f in Relation.ARRAY_FIELDS:
            setattr(self, f, arrays[f])
        self.num_src = int(num_src)
        self.num_dst = int(num_dst)
        self.num_edges = int(num_edges)
        # degree extremes, counted on the host when the relation is built
        # (-1: not known), so no layer call reads the degrees back
        self.max_in_degree = int(max_in_degree)
        self.max_out_degree = int(max_out_degree)
        self.min_in_degree = int(min_in_degree)
        self.min_out_degree = int(min_out_degree)
        self.hub_plan = hub_plan
        self._host = {}
        self._edge_hash = None

    @staticmethod
    def from_coo(src, dst, num_src: int, num_dst: int, *,
                 idtype=torch.int32, num_edges: Optional[int] = None,
                 device="cuda") -> "Relation":
        """Build all formats from a COO edge list on the host.

        ``num_edges`` < len(src) marks the tail as padding (padded edges
        must already point at the virtual rows ``num_src``/``num_dst``).
        The sorts are stable: ties keep edge-id order.
        """
        src = _asnumpy(src)
        dst = _asnumpy(dst)
        if src.shape != dst.shape or src.ndim != 1:
            raise DGLError(
                f"src/dst must be equal-length 1D arrays, got {src.shape} "
                f"vs {dst.shape}")
        E_arr = src.shape[0]
        E = E_arr if num_edges is None else int(num_edges)
        np_id = _np_idtype(idtype)
        src = src.astype(np_id)
        dst = dst.astype(np_id)
        if E > 0:
            real_src, real_dst = src[:E], dst[:E]
            if real_src.min() < 0 or real_src.max() >= num_src:
                raise DGLError(
                    f"src ids out of range [0, {num_src}): "
                    f"min={real_src.min()}, max={real_src.max()}")
            if real_dst.min() < 0 or real_dst.max() >= num_dst:
                raise DGLError(
                    f"dst ids out of range [0, {num_dst}): "
                    f"min={real_dst.min()}, max={real_dst.max()}")

        def build_index(major, nrows):
            # +1: the padding row; padded edges sort to the end. torch's
            # stable sort gives numpy's stable argsort, on several threads
            order = torch.sort(torch.from_numpy(major), stable=True)[
                1].numpy().astype(np_id)
            counts = np.bincount(major, minlength=nrows + 1)
            indptr = np.concatenate(([0], np.cumsum(counts)))
            return indptr[: nrows + 1].astype(np_id), order, major[order]

        def degree(extreme, indptr, nrows):
            if nrows == 0:
                return 0
            return int(extreme(indptr[1: nrows + 1] - indptr[:nrows]))

        csr_indptr, csr_order, csr_src = build_index(src, num_src)
        csc_indptr, csc_order, csc_dst = build_index(dst, num_dst)
        host = {
            "src": src,
            "dst": dst,
            "csr_indptr": csr_indptr,
            "csr_indices": dst[csr_order],
            "csr_eids": csr_order,
            "csr_src": csr_src,
            "csc_indptr": csc_indptr,
            "csc_indices": src[csc_order],
            "csc_eids": csc_order,
            "csc_dst": csc_dst,
        }
        rel = Relation(
            {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
             for k, v in host.items()},
            num_src=num_src, num_dst=num_dst, num_edges=E,
            max_in_degree=degree(np.max, csc_indptr, num_dst),
            max_out_degree=degree(np.max, csr_indptr, num_src),
            min_in_degree=degree(np.min, csc_indptr, num_dst),
            min_out_degree=degree(np.min, csr_indptr, num_src))
        rel._host.update(host)
        return rel

    def _copy_with(self, **overrides) -> "Relation":
        new = Relation.__new__(Relation)
        new.__dict__.update(self.__dict__)
        new.__dict__.update(overrides)
        return new

    def with_hub_plan(self, plan) -> "Relation":
        """A copy carrying a dense-hub SpMM plan (``ops/hub_spmm.py``);
        ``gspmm`` dispatches ``copy_u`` + sum/mean through it."""
        return self._copy_with(hub_plan=plan)

    def with_shell_plan(self, plan) -> "Relation":
        """A copy carrying a full-edge shell plan (``ops/shell_spmm.py``);
        ``gspmm`` dispatches every op with sum/mean/max/min through it
        (after the hub plan's ``copy_u``), ``edge_softmax`` its reductions
        and ``GATConv`` its fused attention."""
        return self._copy_with(shell_plan=plan)

    def with_dense_adj(self, plan) -> "Relation":
        """A copy carrying a dense adjacency mask (``ops/dense_attn.py``);
        ``GATConv`` then runs dense masked attention."""
        return self._copy_with(dense_adj=plan)

    def with_bitmap_plan(self, plan) -> "Relation":
        """A copy carrying a packed-bitmap dense SpMM plan
        (``ops/bitmap_spmm.py``); ``gspmm`` dispatches ``copy_u`` +
        sum/mean through it and ``GATConv`` its attention. Raises when the
        plan was built from another edge set."""
        if plan is not None and plan.edge_hash != self.edge_hash():
            raise DGLError(f"{plan!r} was not built from {self!r}: their "
                           "edge sets differ")
        return self._copy_with(bitmap_plan=plan)

    def to(self, device) -> "Relation":
        arrays = {f: None if getattr(self, f) is None
                  else getattr(self, f).to(device)
                  for f in Relation.ARRAY_FIELDS}
        plans = {k: None if getattr(self, k) is None
                 else getattr(self, k).to(device)
                 for k in ("hub_plan", "shell_plan", "bitmap_plan",
                           "dense_adj")}
        return self._copy_with(**plans, **arrays)

    @property
    def device(self) -> torch.device:
        return self.src.device

    @property
    def num_edges_padded(self) -> int:
        return int(self.src.shape[0])

    def host_arrays(self, *fields) -> tuple:
        """Numpy copies of index arrays for host-side plan builders, cached
        per relation (relations are immutable)."""
        for f in fields:
            if f not in self._host:
                self._host[f] = getattr(self, f).cpu().numpy()
        return tuple(self._host[f] for f in fields)

    def host_edges(self):
        """The real edges' endpoints as (cached) host arrays."""
        src, dst = self.host_arrays("src", "dst")
        return src[: self.num_edges], dst[: self.num_edges]

    def in_degrees(self) -> torch.Tensor:
        if self.csc_indptr is None:
            raise DGLError(
                "CSC format not materialized on this graph; request it "
                "with g.formats(['csc', ...]) (format-restricted build)")
        return self.csc_indptr[1:] - self.csc_indptr[:-1]

    def out_degrees(self) -> torch.Tensor:
        if self.csr_indptr is None:
            raise DGLError(
                "CSR format not materialized on this graph; request it "
                "with g.formats(['csr', ...]) (format-restricted build)")
        return self.csr_indptr[1:] - self.csr_indptr[:-1]

    def first_eids(self, u, v) -> np.ndarray:
        """On the host, the id of the first edge ``u[i] -> v[i]`` in CSR
        order (the smallest such id: a source's CSR run keeps edge-id
        order), -1 where there is none; one sorted search over the real
        edges' ``src * num_dst + dst`` keys, built once a relation."""
        if "edge_key_order" not in self._host:
            src, dst = self.host_edges()
            keys = src.astype(np.int64) * self.num_dst + dst
            order = np.argsort(keys, kind="stable")
            self._host["edge_key_order"] = (keys[order], order)
        keys, order = self._host["edge_key_order"]
        q = (np.asarray(u, np.int64) * self.num_dst
             + np.asarray(v, np.int64))
        pos = np.searchsorted(keys, q)
        hit = pos < keys.shape[0]
        hit[hit] = keys[pos[hit]] == q[hit]
        return np.where(hit, order[np.minimum(pos, max(len(order) - 1, 0))]
                        if len(order) else -1, -1)

    def edge_mask(self) -> torch.Tensor:
        """Boolean (E_padded,) mask of the real (non-padding) edges."""
        return (torch.arange(self.num_edges_padded, device=self.device)
                < self.num_edges)

    def reverse(self) -> "Relation":
        """The relation with src and dst swapped: CSR and CSC trade places
        (reference ``UnitGraph`` reverse view). No copy; plans stay
        behind."""
        swap = {"src": "dst", "dst": "src", "csr_indptr": "csc_indptr",
                "csr_indices": "csc_indices", "csr_eids": "csc_eids",
                "csr_src": "csc_dst", "csc_indptr": "csr_indptr",
                "csc_indices": "csr_indices", "csc_eids": "csr_eids",
                "csc_dst": "csr_src"}
        return Relation({f: getattr(self, swap[f])
                         for f in Relation.ARRAY_FIELDS},
                        num_src=self.num_dst, num_dst=self.num_src,
                        num_edges=self.num_edges,
                        max_in_degree=self.max_out_degree,
                        max_out_degree=self.max_in_degree,
                        min_in_degree=self.min_out_degree,
                        min_out_degree=self.min_in_degree)

    def edge_keys(self) -> torch.Tensor:
        """Sorted distinct ``dst * num_src + src`` keys of the real edges:
        fewer than ``num_edges`` of them when the relation has
        multi-edges."""
        src, dst = self.src[:self.num_edges], self.dst[:self.num_edges]
        return torch.unique(dst.to(torch.int64) * self.num_src
                            + src.to(torch.int64))

    def edge_hash(self) -> int:
        """A hash of the set of (src, dst) pairs of the real edges, the
        same on every device; counted once (one read from the device) and
        kept by copies and moves. A bitmap plan records its relation's."""
        if self._edge_hash is None:
            self._edge_hash = _hash_keys(self.edge_keys())
        return self._edge_hash

    def has_multi_edges(self) -> bool:
        """Whether two real edges join the same (src, dst) pair."""
        return int(self.edge_keys().numel()) != self.num_edges

    def __repr__(self):
        return (f"Relation(num_src={self.num_src}, num_dst={self.num_dst}, "
                f"num_edges={self.num_edges})")


# ---------------------------------------------------------------------------
# Data views (ndata / srcdata / dstdata / edata; reference view.py)
# ---------------------------------------------------------------------------


class _DataView(Mapping):
    """A mapping over the frame ``_frame()`` resolves; setting is the
    subclass's."""

    __slots__ = ()

    def __getitem__(self, key):
        return self._frame()[key]

    def __delitem__(self, key):
        del self._frame()[key]

    def __iter__(self):
        return iter(self._frame())

    def __len__(self):
        return len(self._frame())

    def pop(self, key):
        return self._frame().pop(key)

    def update(self, other):
        for key, value in dict(other).items():
            self[key] = value

    def __repr__(self):
        return repr(dict(self._frame()))


class HeteroNodeDataView(_DataView):
    """``g.ndata`` / ``g.srcdata`` / ``g.dstdata`` (counterpart of
    ``dgl_tpu.graph.HeteroNodeDataView``). With one node type of its role
    (``"node"``, ``"src"`` or ``"dst"``) it is that type's frame; with
    several, reading needs ``g.nodes[ntype].data`` and setting takes a dict
    of per-type values. Values are checked against the type's row count."""

    __slots__ = ("_graph", "_ntype", "_role")

    def __init__(self, graph: "Graph", ntype: Optional[str], role: str):
        self._graph = graph
        self._ntype = ntype
        self._role = role

    def _types(self):
        g = self._graph
        if self._role == "src":
            return g.srctypes
        if self._role == "dst":
            return g.dsttypes
        return g.ntypes

    def _frame(self, ntype=None) -> Dict[str, Any]:
        nt = ntype if ntype is not None else self._ntype
        if nt is None:
            types = self._types()
            if len(types) != 1:
                raise DGLError(
                    "Graph has multiple node types; use g.nodes[ntype].data "
                    "or pass an explicit ntype.")
            nt = types[0]
        frames = (self._graph._dst_frames if self._role == "dst"
                  else self._graph._node_frames)
        return frames.setdefault(nt, {})

    def _check_shape(self, ntype, value):
        g = self._graph
        n = (g.num_dst_nodes(ntype) if self._role == "dst"
             else g.num_src_nodes(ntype) if self._role == "src"
             else g.num_nodes(ntype))
        if value.shape[0] != n:
            raise DGLError(f"Feature first dim {value.shape[0]} != number "
                           f"of {self._role} nodes {n} for ntype {ntype!r}")

    def __setitem__(self, key, value):
        if self._ntype is None and len(self._types()) > 1:
            if not isinstance(value, Mapping):
                raise DGLError("Setting ndata on a graph with multiple node "
                               "types requires a dict of per-type values.")
            for nt, v in value.items():
                self._check_shape(nt, v)
                self._frame(nt)[key] = v
            return
        nt = self._ntype if self._ntype is not None else self._types()[0]
        self._check_shape(nt, value)
        self._frame(nt)[key] = value


class HeteroEdgeDataView(_DataView):
    """``g.edata`` (counterpart of ``dgl_tpu.graph.HeteroEdgeDataView``):
    one edge type's frame; with several, reading needs
    ``g.edges_view[etype].data`` and setting takes a dict keyed by etype.
    Values hold ``num_edges`` or the padded count of rows."""

    __slots__ = ("_graph", "_etype")

    def __init__(self, graph: "Graph", etype=None):
        self._graph = graph
        self._etype = etype

    def _cet(self, etype=None) -> CanonicalEtype:
        g = self._graph
        et = etype if etype is not None else self._etype
        if et is None and len(g.canonical_etypes) != 1:
            raise DGLError("Graph has multiple edge types; use "
                           "g.edges_view[etype].data.")
        return g.to_canonical_etype(et)

    def _frame(self, etype=None) -> Dict[str, Any]:
        return self._graph._edge_frames.setdefault(self._cet(etype), {})

    def _set(self, cet, key, value):
        rel = self._graph._relations[cet]
        if value.shape[0] not in (rel.num_edges, rel.num_edges_padded):
            raise DGLError(f"Feature first dim {value.shape[0]} != number "
                           f"of edges {rel.num_edges} for etype {cet!r}")
        self._graph._edge_frames.setdefault(cet, {})[key] = value

    def __setitem__(self, key, value):
        if self._etype is None and len(self._graph.canonical_etypes) > 1:
            if not isinstance(value, Mapping):
                raise DGLError("Setting edata on a graph with multiple edge "
                               "types requires a dict of per-etype values.")
            for et, v in value.items():
                self._set(self._cet(et), key, v)
            return
        self._set(self._cet(), key, value)


class _TypedView:
    """``g.nodes[ntype].data`` / ``g.edges_view[etype].data``."""

    __slots__ = ("_graph", "_kind")

    def __init__(self, graph, kind):
        self._graph = graph
        self._kind = kind

    def __getitem__(self, key):
        view = (HeteroNodeDataView(self._graph, key, "node")
                if self._kind == "node"
                else HeteroEdgeDataView(self._graph, key))
        return _TypedData(view)


class _TypedData:
    __slots__ = ("data",)

    def __init__(self, view):
        self.data = view


# ---------------------------------------------------------------------------
# Graph
# ---------------------------------------------------------------------------


class Graph:
    """Graph or block of one or more node and edge types, with feature
    frames.

    Counterpart of ``dgl_tpu.graph.Graph`` (reference ``DGLGraph``). Each
    canonical edge type ``(src_type, etype, dst_type)`` is a
    :class:`Relation`. A block (``is_block=True``, a message-flow graph)
    has separate source and destination node spaces, which may hold other
    types: ``srcdata`` (also ``ndata``) holds ``num_src_nodes()`` rows,
    ``dstdata`` ``num_dst_nodes()`` rows in frames of their own. On a
    graph both views share one frame per type.
    """

    # per-type graph sizes of a batch (``batch.py``); None: one graph
    _batch_num_nodes = None
    _batch_num_edges = None

    def __init__(self, relations: Dict[CanonicalEtype, Relation],
                 num_src_nodes: Dict[str, int],
                 num_dst_nodes: Optional[Dict[str, int]] = None,
                 is_block: bool = False):
        self._relations = dict(relations)
        self._canonical_etypes = tuple(self._relations)
        self._num_src_nodes = dict(num_src_nodes)
        self._num_dst_nodes = dict(num_dst_nodes if num_dst_nodes is not None
                                   else num_src_nodes)
        self._is_block = bool(is_block)
        self._node_frames: Dict[str, Dict[str, Any]] = {}
        # a block's destination nodes have their own frames; a graph's
        # are its node frames
        self._dst_frames = {} if self._is_block else self._node_frames
        self._edge_frames: Dict[CanonicalEtype, Dict[str, Any]] = {}
        for (st, et, dt) in self._relations:
            if st not in self._num_src_nodes or dt not in self._num_dst_nodes:
                raise DGLError(f"Unknown node type in relation ({st},{et},"
                               f"{dt})")

    # -- schema ------------------------------------------------------------

    @property
    def is_block(self) -> bool:
        return self._is_block

    @property
    def canonical_etypes(self) -> Tuple[CanonicalEtype, ...]:
        return self._canonical_etypes

    @property
    def etypes(self):
        return [et for _, et, _ in self._canonical_etypes]

    @property
    def ntypes(self):
        """Node types in the reference's order: the source types, then a
        block's destination types not among them."""
        seen = dict.fromkeys(self._num_src_nodes)
        if self._is_block:
            seen.update(dict.fromkeys(self._num_dst_nodes))
        return list(seen)

    @property
    def srctypes(self):
        return list(self._num_src_nodes)

    @property
    def dsttypes(self):
        return list(self._num_dst_nodes)

    @property
    def is_homogeneous(self) -> bool:
        return len(self.ntypes) == 1 and len(self._canonical_etypes) == 1

    def _first_relation(self) -> Relation:
        return next(iter(self._relations.values()))

    @property
    def idtype(self):
        return self._first_relation().src.dtype

    @property
    def device(self) -> torch.device:
        return self._first_relation().device

    def to_canonical_etype(self, etype) -> CanonicalEtype:
        """Resolve an edge type name or triplet (reference
        ``heterograph.py:1121``)."""
        if etype is None:
            if len(self._canonical_etypes) != 1:
                raise DGLError(
                    "Edge type name must be specified for graphs with "
                    f"multiple edge types: {self._canonical_etypes}")
            return self._canonical_etypes[0]
        if isinstance(etype, tuple):
            if tuple(etype) not in self._relations:
                raise DGLError(f"Unknown canonical etype {etype}")
            return tuple(etype)
        matches = [c for c in self._canonical_etypes if c[1] == etype]
        if not matches:
            raise DGLError(f"Unknown edge type {etype!r}")
        if len(matches) > 1:
            raise DGLError(f"Edge type {etype!r} is ambiguous; use a "
                           f"canonical triplet. Candidates: {matches}")
        return matches[0]

    def _relation(self, etype=None) -> Relation:
        return self._relations[self.to_canonical_etype(etype)]

    # -- counts --------------------------------------------------------------

    def num_nodes(self, ntype: Optional[str] = None) -> int:
        """A type's node count, or without ``ntype`` the total; on a block
        the source nodes', which hold the destination nodes first."""
        if self._is_block:
            return self.num_src_nodes(ntype)
        if ntype is None:
            return sum(self._num_src_nodes.values())
        if ntype not in self._num_src_nodes:
            raise DGLError(f"Unknown node type {ntype!r}")
        return self._num_src_nodes[ntype]

    def num_src_nodes(self, ntype: Optional[str] = None) -> int:
        if ntype is None:
            return sum(self._num_src_nodes.values())
        return self._num_src_nodes[ntype]

    def num_dst_nodes(self, ntype: Optional[str] = None) -> int:
        if ntype is None:
            return sum(self._num_dst_nodes.values())
        return self._num_dst_nodes[ntype]

    def num_edges(self, etype=None) -> int:
        if etype is None and len(self._canonical_etypes) > 1:
            return sum(r.num_edges for r in self._relations.values())
        return self._relation(etype).num_edges

    def number_of_nodes(self, ntype: Optional[str] = None) -> int:
        return self.num_nodes(ntype)

    def number_of_edges(self, etype=None) -> int:
        return self.num_edges(etype)

    # -- data views ----------------------------------------------------------

    @property
    def ndata(self):
        return HeteroNodeDataView(self, None, "node")

    @property
    def srcdata(self):
        return HeteroNodeDataView(self, None, "src")

    @property
    def dstdata(self):
        return HeteroNodeDataView(self, None, "dst")

    @property
    def edata(self):
        return HeteroEdgeDataView(self, None)

    @property
    def nodes(self):
        """``g.nodes[ntype].data``: one node type's frame."""
        return _TypedView(self, "node")

    @property
    def edges_view(self):
        """``g.edges_view[etype].data``: one edge type's frame."""
        return _TypedView(self, "edge")

    # -- structure queries ---------------------------------------------------

    def edges(self, form: str = "uv", order: str = "eid", etype=None):
        """Edge endpoints (reference ``heterograph.py`` ``all_edges``), the
        padded edges included: ``order="eid"`` in edge-id order,
        ``"srcdst"`` grouped by source."""
        rel = self._relation(etype)
        if order == "eid":
            u, v = rel.src, rel.dst
            e = torch.arange(rel.num_edges_padded, dtype=u.dtype,
                             device=u.device)
        elif order == "srcdst":
            u, v, e = rel.csr_src, rel.csr_indices, rel.csr_eids
        else:
            raise DGLError(f"Unknown edge order {order!r}")
        if form == "uv":
            return u, v
        if form == "all":
            return u, v, e
        if form == "eid":
            return e
        raise DGLError(f"Unknown form {form!r}")

    def in_degrees(self, v=ALL, etype=None):
        deg = self._relation(etype).in_degrees()
        if is_all(v):
            return deg
        return deg[torch.as_tensor(v, device=deg.device)]

    def out_degrees(self, u=ALL, etype=None):
        deg = self._relation(etype).out_degrees()
        if is_all(u):
            return deg
        return deg[torch.as_tensor(u, device=deg.device)]

    # -- message passing (implemented in core.py) ----------------------------

    def apply_nodes(self, func, v=ALL, ntype=None):
        from . import core

        return core.apply_nodes(self, func, v=v, ntype=ntype)

    def apply_edges(self, func, edges=ALL, etype=None):
        from . import core

        return core.apply_edges_(self, func, edges=edges, etype=etype)

    def update_all(self, message_func, reduce_func, apply_node_func=None,
                   etype=None):
        from . import core

        return core.update_all_(self, message_func, reduce_func,
                                apply_node_func, etype=etype)

    def multi_update_all(self, etype_dict, cross_reducer,
                         apply_node_func=None):
        from . import core

        return core.multi_update_all_(self, etype_dict, cross_reducer,
                                      apply_node_func)

    def pull(self, v, message_func, reduce_func, apply_node_func=None,
             etype=None):
        from . import core

        return core.pull(self, v, message_func, reduce_func,
                         apply_node_func, etype=etype)

    def push(self, u, message_func, reduce_func, apply_node_func=None,
             etype=None):
        from . import core

        return core.push(self, u, message_func, reduce_func,
                         apply_node_func, etype=etype)

    def send_and_recv(self, edges, message_func, reduce_func,
                      apply_node_func=None, etype=None):
        from . import core

        return core.send_and_recv(self, edges, message_func, reduce_func,
                                  apply_node_func, etype=etype)

    def prop_nodes(self, nodes_generator, message_func, reduce_func,
                   apply_node_func=None, etype=None):
        from . import propagate

        return propagate.prop_nodes(self, nodes_generator, message_func,
                                    reduce_func, apply_node_func,
                                    etype=etype)

    def prop_edges(self, edges_generator, message_func, reduce_func,
                   apply_node_func=None, etype=None):
        from . import propagate

        return propagate.prop_edges(self, edges_generator, message_func,
                                    reduce_func, apply_node_func,
                                    etype=etype)

    def local_scope(self):
        """Context manager isolating frame mutations."""
        return _LocalScope(self)

    def structural_clone(self) -> "Graph":
        g = Graph.__new__(Graph)
        g.__dict__.update(self.__dict__)
        return g

    def to(self, device) -> "Graph":
        """A copy with every index tensor, plan and feature on ``device``."""
        g = self.structural_clone()
        g._relations = {k: r.to(device) for k, r in self._relations.items()}
        g._node_frames = {nt: {k: v.to(device) for k, v in f.items()}
                          for nt, f in self._node_frames.items()}
        g._dst_frames = (g._node_frames if not self._is_block else
                         {nt: {k: v.to(device) for k, v in f.items()}
                          for nt, f in self._dst_frames.items()})
        g._edge_frames = {et: {k: v.to(device) for k, v in f.items()}
                          for et, f in self._edge_frames.items()}
        for attr in ("_batch_num_nodes", "_batch_num_edges"):
            counts = getattr(self, attr)
            if counts is not None:
                setattr(g, attr, {k: v.to(device)
                                  for k, v in counts.items()})
        return g

    # -- SpMM plans ----------------------------------------------------------

    @staticmethod
    def _auto_num_hubs(rel) -> int:
        """Smallest power-of-two H (128..4096) whose top-H sources cover
        >= 50% of edges; below that, the coverage elbow."""
        src, dst = rel.host_arrays("csc_indices", "csc_dst")
        real = (src < rel.num_src) & (dst < rel.num_dst)
        e = int(real.sum())
        if e == 0:
            return 128
        deg = np.bincount(src[real], minlength=rel.num_src)
        cum = np.cumsum(np.sort(deg)[::-1])
        candidates = [h for h in (128, 256, 512, 1024, 2048, 4096)
                      if h <= rel.num_src] or [rel.num_src]
        for h in candidates:
            if cum[min(h, cum.shape[0]) - 1] / e >= 0.5:
                return h
        best = candidates[0]
        for prev, h in zip(candidates, candidates[1:]):
            gain = (cum[min(h, cum.shape[0]) - 1]
                    - cum[min(prev, cum.shape[0]) - 1]) / e
            if gain < 0.05:
                break
            best = h
        return best

    def with_spmm_plans(self, num_hubs=2048,
                        precision: str = "int8",
                        weighted: bool = False,
                        gather_dtype: str = "bf16",
                        dense_attn: bool | str = "auto",
                        dense_attn_max_cells: int = 16_000_000,
                        bitmap: bool | str = "auto",
                        bitmap_max_bytes: int = 2 << 30,
                        bitmap_min_density: float = 5e-4) -> "Graph":
        """A copy whose relations carry the reference's SpMM plans, each
        relation's built and gated on its own (reference
        ``graph.py:1112-1184``; bipartite relations included).

        - A dense-hub plan (:mod:`dgl_tpu_torch.ops.hub_spmm`), always.
        - A packed-bitmap plan (:mod:`dgl_tpu_torch.ops.bitmap_spmm`) when
          ``bitmap=True``, or with ``"auto"`` on a dense relation (density
          ``E/(N_src*N_dst) >= bitmap_min_density`` and bitmaps within
          ``2 * bitmap_max_bytes``); the builder still refuses multi-edges
          and plans over ``bitmap_max_bytes``.
        - With ``weighted=True``, a full-edge shell plan
          (:mod:`dgl_tpu_torch.ops.shell_spmm`, gathers in
          ``gather_dtype``), so edge-weighted sum/mean ops, max/min, the
          edge softmax and GATConv's fused attention skip the segment
          reductions as well.
        - A dense adjacency mask (:mod:`dgl_tpu_torch.ops.dense_attn`,
          ``Relation.dense_adj``) when ``dense_attn`` is not False, the
          relation has at most ``dense_attn_max_cells`` cells and no
          multi-edges: ``GATConv`` then runs dense masked attention."""
        from .ops.hub_spmm import build_hub_plan
        from .ops.shell_spmm import build_shell_plan

        g = self.structural_clone()
        rels = {}
        for k, r in self._relations.items():
            h = (self._auto_num_hubs(r) if num_hubs == "auto"
                 else int(num_hubs))
            r = r.with_hub_plan(build_hub_plan(r, h, precision))
            if weighted:
                r = r.with_shell_plan(build_shell_plan(r, gather_dtype))
            rels[k] = with_dense_plans(
                r, dense_attn=dense_attn,
                dense_attn_max_cells=dense_attn_max_cells, bitmap=bitmap,
                bitmap_max_bytes=bitmap_max_bytes,
                bitmap_min_density=bitmap_min_density)
        g._relations = rels
        return g

    # -- batch info (reference ``python/dgl/batch.py``) ---------------------

    @property
    def batch_size(self) -> int:
        if self._batch_num_nodes is None:
            return 1
        for v in self._batch_num_nodes.values():
            return int(v.shape[0])
        return 1

    def _one_ntype(self, role: str) -> str:
        types = self.srctypes if role == "src" else self.dsttypes
        if len(types) != 1:
            raise DGLError("ntype must be given for graphs with multiple "
                           "node types")
        return types[0]

    def batch_num_nodes(self, ntype: Optional[str] = None) -> torch.Tensor:
        """Nodes of each graph of a batch (one graph: all of them)."""
        nt = ntype or self._one_ntype("src")
        if self._batch_num_nodes is None:
            return torch.tensor([self.num_nodes(nt)], device=self.device)
        return self._batch_num_nodes[nt]

    def batch_num_edges(self, etype=None) -> torch.Tensor:
        """Edges of each graph of a batch (one graph: all of them)."""
        cet = self.to_canonical_etype(etype)
        if self._batch_num_edges is None:
            return torch.tensor([self.num_edges(cet)], device=self.device)
        return self._batch_num_edges[cet]

    def set_batch_num_nodes(self, d):
        if not isinstance(d, dict):
            d = {self._one_ntype("src"): d}
        self._batch_num_nodes = {
            k: torch.as_tensor(_asnumpy(v), device=self.device)
            for k, v in d.items()}

    def set_batch_num_edges(self, d):
        if not isinstance(d, dict):
            d = {self.canonical_etypes[0]: d}
        self._batch_num_edges = {
            self.to_canonical_etype(k): torch.as_tensor(
                _asnumpy(v), device=self.device) for k, v in d.items()}

    # -- queries (reference ``heterograph.py``) -------------------------------

    def _on_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def nodes_ids(self, ntype: Optional[str] = None) -> torch.Tensor:
        """All node ids of a type (reference ``nodes()``)."""
        n = self.num_nodes(ntype) if ntype else self.num_nodes(
            self.ntypes[0] if len(self.ntypes) == 1 else None)
        return torch.arange(n, dtype=self.idtype, device=self.device)

    def all_edges(self, form="uv", order="eid", etype=None):
        return self.edges(form=form, order=order, etype=etype)

    def find_edges(self, eid, etype=None):
        """Endpoints of the edges ``eid``."""
        rel = self._relation(etype)
        eid = torch.as_tensor(_asnumpy(eid), device=rel.device).long()
        return rel.src[eid], rel.dst[eid]

    def has_nodes(self, vids, ntype=None):
        nt = ntype or (self.ntypes[0] if len(self.ntypes) == 1 else None)
        v = torch.atleast_1d(torch.as_tensor(_asnumpy(vids),
                                             device=self.device))
        out = (v >= 0) & (v < self.num_nodes(nt))
        return out if np.ndim(_asnumpy(vids)) else out[0]

    def has_edges_between(self, u, v, etype=None):
        """Whether each ``u[i] -> v[i]`` is an edge: a 0-dim tensor for a
        single pair, as in the reference."""
        rel = self._relation(etype)
        u = np.atleast_1d(_asnumpy(u))
        v = np.atleast_1d(_asnumpy(v))
        res = self._on_device(rel.first_eids(u, v) >= 0)
        return res if res.shape[0] > 1 else res[0]

    def edge_ids(self, u, v, etype=None):
        """The id of edge ``u[i] -> v[i]``, the first in CSR order (the
        smallest id) among multi-edges; raises for a missing edge."""
        rel = self._relation(etype)
        u = np.atleast_1d(_asnumpy(u))
        v = np.atleast_1d(_asnumpy(v))
        eids = rel.first_eids(u, v)
        missing = np.nonzero(eids < 0)[0]
        if missing.size:
            i = missing[0]
            raise DGLError(f"Edge ({u[i]},{v[i]}) does not exist")
        return self._on_device(eids.astype(_np_idtype(self.idtype)))

    def successors(self, u, etype=None):
        rel = self._relation(etype)
        indptr, indices = rel.host_arrays("csr_indptr", "csr_indices")
        u = int(u)
        return self._on_device(indices[indptr[u]: indptr[u + 1]])

    def predecessors(self, v, etype=None):
        rel = self._relation(etype)
        indptr, indices = rel.host_arrays("csc_indptr", "csc_indices")
        v = int(v)
        return self._on_device(indices[indptr[v]: indptr[v + 1]])

    def _edges_of(self, rel, eids, form):
        src, dst = rel.host_arrays("src", "dst")
        if form == "eid":
            return self._on_device(eids)
        if form == "uv":
            return self._on_device(src[eids]), self._on_device(dst[eids])
        if form == "all":
            return (self._on_device(src[eids]), self._on_device(dst[eids]),
                    self._on_device(eids))
        raise DGLError(f"Unknown form {form!r}")

    def in_edges(self, v, form: str = "uv", etype=None):
        """In-edges of the nodes ``v``, node by node in CSC order."""
        rel = self._relation(etype)
        indptr, eids = rel.host_arrays("csc_indptr", "csc_eids")
        seeds = np.atleast_1d(_asnumpy(v)).astype(np.int64)
        return self._edges_of(rel, ragged_gather(indptr, eids, seeds), form)

    def out_edges(self, u, form: str = "uv", etype=None):
        """Out-edges of the nodes ``u``, node by node in CSR order."""
        rel = self._relation(etype)
        indptr, eids = rel.host_arrays("csr_indptr", "csr_eids")
        seeds = np.atleast_1d(_asnumpy(u)).astype(np.int64)
        return self._edges_of(rel, ragged_gather(indptr, eids, seeds), form)

    def node_attr_schemes(self, ntype=None):
        nt = ntype or (self.ntypes[0] if len(self.ntypes) == 1 else None)
        frame = self._node_frames.get(nt, {})
        return {k: (tuple(v.shape[1:]), v.dtype) for k, v in frame.items()}

    # -- structure facts ------------------------------------------------------

    @property
    def is_multigraph(self) -> bool:
        return any(r.has_multi_edges() for r in self._relations.values())

    def metagraph(self):
        """networkx MultiDiGraph over the node types (reference
        ``metagraph``)."""
        import networkx as nx

        mg = nx.MultiDiGraph()
        mg.add_nodes_from(self.ntypes)
        for st, et, dt in self.canonical_etypes:
            mg.add_edge(st, dt, key=et)
        return mg

    def get_ntype_id(self, ntype) -> int:
        if ntype is None:
            if len(self.ntypes) != 1:
                raise DGLError("ntype required")
            return 0
        try:
            return self.ntypes.index(ntype)
        except ValueError:
            raise DGLError(f"Unknown node type {ntype!r}") from None

    def get_etype_id(self, etype) -> int:
        return self.canonical_etypes.index(self.to_canonical_etype(etype))

    @property
    def is_unibipartite(self) -> bool:
        """True when the source and destination node types are disjoint."""
        srcs = {cet[0] for cet in self.canonical_etypes}
        dsts = {cet[2] for cet in self.canonical_etypes}
        return not srcs & dsts

    def number_of_src_nodes(self, ntype: Optional[str] = None) -> int:
        return self.num_src_nodes(ntype)

    def number_of_dst_nodes(self, ntype: Optional[str] = None) -> int:
        return self.num_dst_nodes(ntype)

    # -- copies and views -----------------------------------------------------

    def reverse(self, copy_ndata=True, copy_edata=True) -> "Graph":
        """Every relation reversed, without plans (reference
        ``dgl.reverse``)."""
        rels = {(dt, et, st): rel.reverse()
                for (st, et, dt), rel in self._relations.items()}
        g = Graph(rels, num_src_nodes=dict(self._num_dst_nodes),
                  num_dst_nodes=dict(self._num_src_nodes))
        if copy_ndata:
            for nt, f in self._node_frames.items():
                g._node_frames[nt] = dict(f)
        if copy_edata:
            for (st, et, dt), f in self._edge_frames.items():
                g._edge_frames[(dt, et, st)] = dict(f)
        return g

    def local_var(self) -> "Graph":
        """A view sharing the structure whose frames are copies."""
        g = self.structural_clone()
        g._node_frames = {nt: dict(f) for nt, f in self._node_frames.items()}
        g._dst_frames = (g._node_frames if not self._is_block else
                         {nt: dict(f) for nt, f in self._dst_frames.items()})
        g._edge_frames = {et: dict(f) for et, f in self._edge_frames.items()}
        return g

    def clone(self) -> "Graph":
        return self.local_var()

    def cpu(self) -> "Graph":
        return self.to("cpu")

    def astype(self, idtype) -> "Graph":
        """The index tensors cast to ``idtype``; plans are left behind
        (their index arrays keep theirs)."""
        _np_idtype(idtype)

        def conv(rel: Relation) -> Relation:
            arrays = {f: None if getattr(rel, f) is None
                      else getattr(rel, f).to(idtype)
                      for f in Relation.ARRAY_FIELDS}
            return rel._copy_with(hub_plan=None, shell_plan=None,
                                  bitmap_plan=None, dense_adj=None,
                                  _host={}, **arrays)

        g = self.structural_clone()
        g._relations = {k: conv(r) for k, r in self._relations.items()}
        return g

    def long(self) -> "Graph":
        return self.astype(torch.int64)

    def int(self) -> "Graph":
        return self.astype(torch.int32)

    def to_networkx(self, node_attrs=None, edge_attrs=None):
        """A networkx MultiDiGraph of a graph of one edge type, each edge
        with its id as ``id`` (reference ``to_networkx``)."""
        import networkx as nx

        nxg = nx.MultiDiGraph()
        nxg.add_nodes_from(range(self.num_nodes()))
        src, dst = self._relation(None).host_edges()
        cet = self.canonical_etypes[0]
        efr = {k: _asnumpy(self._edge_frames[cet][k])
               for k in edge_attrs or ()}
        for i, (u, v) in enumerate(zip(src, dst)):
            nxg.add_edge(int(u), int(v), id=i,
                         **{k: a[i] for k, a in efr.items()})
        if node_attrs:
            nt = self.ntypes[0]
            for k in node_attrs:
                vals = _asnumpy(self._node_frames[nt][k])
                for i in range(self.num_nodes()):
                    nxg.nodes[i][k] = vals[i]
        return nxg

    # -- frames and formats ---------------------------------------------------

    def set_n_initializer(self, initializer, field=None, ntype=None):
        """A default for new node rows (reference ``set_n_initializer``):
        ``add_nodes`` fills with ``initializer(shape, dtype)``, not 0."""
        self.__dict__.setdefault("_n_initializers", {})[
            (ntype, field)] = initializer

    def set_e_initializer(self, initializer, field=None, etype=None):
        self.__dict__.setdefault("_e_initializers", {})[
            (etype, field)] = initializer

    def _get_initializer(self, kind, field, type_key):
        store = self.__dict__.get(
            "_n_initializers" if kind == "node" else "_e_initializers", {})
        for key in ((type_key, field), (None, field), (type_key, None),
                    (None, None)):
            if key in store:
                return store[key]
        return None

    def formats(self, formats=None):
        """Without arguments, which sparse formats every relation holds;
        with a list, a copy whose relations hold only those (COO always),
        rebuilt from the COO on the host (reference
        ``heterograph.py:6090``). An op that needs a missing format
        raises."""
        if formats is None:
            rels = list(self._relations.values())
            created = ["coo"]
            if all(r.csr_indptr is not None for r in rels):
                created.append("csr")
            if all(r.csc_indptr is not None for r in rels):
                created.append("csc")
            return {"created": created,
                    "not created": [f for f in ("coo", "csr", "csc")
                                    if f not in created]}
        if isinstance(formats, str):
            formats = [formats]
        g = self.structural_clone()
        rels = {}
        for k, r in self._relations.items():
            src, dst = r.host_arrays("src", "dst")
            new = Relation.from_coo(src, dst, r.num_src, r.num_dst,
                                    idtype=r.src.dtype,
                                    num_edges=r.num_edges, device=r.device)
            for fmt in ("csr", "csc"):
                if fmt not in formats:
                    new = new._copy_with(**{
                        f: None for f in Relation.ARRAY_FIELDS
                        if f.startswith(fmt + "_")})
                    setattr(new, f"max_{'out' if fmt == 'csr' else 'in'}"
                                 "_degree", -1)
            new._host = {}
            rels[k] = new
        g._relations = rels
        return g

    # -- sparse matrices ------------------------------------------------------

    def adj(self, etype=None, eweight_name=None):
        """The adjacency as a :class:`~dgl_tpu_torch.sparse.SparseMatrix`
        of shape (num_src, num_dst) over this relation, plans and padded
        edges included: values 1 (0 on padded edges) or the edge feature
        ``eweight_name``."""
        from .sparse.sparse_matrix import SparseMatrix

        cet = self.to_canonical_etype(etype)
        rel = self._relations[cet]
        if eweight_name is not None:
            return SparseMatrix(rel, self._edge_frames[cet][eweight_name])
        return SparseMatrix(rel, rel.edge_mask().to(torch.float32))

    def adjacency_matrix(self, transpose=False, etype=None):
        a = self.adj(etype=etype)
        return a.T if transpose else a

    def inc(self, typestr="both", etype=None):
        """The (N, E) incidence matrix: ``in``, ``out`` or ``both`` (+1 at
        the destination, -1 at the source, self-loops left out)."""
        from .sparse.sparse_matrix import from_coo

        rel = self._relation(etype)
        E = rel.num_edges
        src, dst = rel.host_edges()
        eid = np.arange(E, dtype=src.dtype)
        n, dev = self.num_nodes(), self.device
        ones = torch.ones(E, dtype=torch.float32, device=dev)
        if typestr == "in":
            return from_coo(dst, eid, ones, (n, E), device=dev)
        if typestr == "out":
            return from_coo(src, eid, ones, (n, E), device=dev)
        keep = src != dst
        k = int(keep.sum())
        rows = np.concatenate([dst[keep], src[keep]])
        cols = np.concatenate([np.nonzero(keep)[0]] * 2)
        vals = np.concatenate([np.ones(k, np.float32),
                               -np.ones(k, np.float32)])
        return from_coo(rows, cols, vals, (n, E), device=dev)

    incidence_matrix = inc

    # -- subgraphs (``subgraph.py``) and transforms (``transforms/``) ---------

    def subgraph(self, nodes, *, relabel_nodes=True, store_ids=True):
        from .subgraph import node_subgraph

        return node_subgraph(self, nodes, relabel_nodes=relabel_nodes,
                             store_ids=store_ids)

    def edge_subgraph(self, edges, *, relabel_nodes=True, store_ids=True):
        from .subgraph import edge_subgraph

        return edge_subgraph(self, edges, relabel_nodes=relabel_nodes,
                             store_ids=store_ids)

    def node_type_subgraph(self, ntypes):
        from .subgraph import node_type_subgraph

        return node_type_subgraph(self, ntypes)

    def edge_type_subgraph(self, etypes):
        from .subgraph import edge_type_subgraph

        return edge_type_subgraph(self, etypes)

    def filter_nodes(self, predicate, ntype=None):
        """Ids of the nodes where ``predicate(NodeBatch)`` holds."""
        from .udf import NodeBatch

        nt = ntype or (self.ntypes[0] if len(self.ntypes) == 1 else None)
        if nt is None:
            raise DGLError("ntype required")
        mask = predicate(NodeBatch(dict(self._node_frames.get(nt, {}))))
        return torch.nonzero(torch.as_tensor(mask)).reshape(-1)

    def filter_edges(self, predicate, etype=None):
        """Ids of the real edges where ``predicate(EdgeBatch)`` holds; the
        padded edges' endpoints read the last row, as in the reference."""
        from .udf import EdgeBatch

        cet = self.to_canonical_etype(etype)
        rel = self._relations[cet]
        s = rel.src.long().clamp(max=max(rel.num_src - 1, 0))
        d = rel.dst.long().clamp(max=max(rel.num_dst - 1, 0))
        srcf = self._node_frames.get(cet[0], {})
        dstf = self._dst_frames.get(cet[2], {})
        batch = EdgeBatch({k: v[s] for k, v in srcf.items()},
                          dict(self._edge_frames.get(cet, {})),
                          {k: v[d] for k, v in dstf.items()},
                          edges=(rel.src, rel.dst))
        mask = torch.as_tensor(predicate(batch)) & rel.edge_mask()
        return torch.nonzero(mask).reshape(-1)

    def shared_memory(self, name: str, formats=None):
        raise NotImplementedError(
            "Graph.shared_memory comes with multiprocessing_mod: ROADMAP "
            "queue A12")

    def __repr__(self):
        if self._is_block:
            return (f"Block(num_src_nodes={self.num_src_nodes()}, "
                    f"num_dst_nodes={self.num_dst_nodes()}, "
                    f"num_edges={self.num_edges()}, device={self.device})")
        if not self.is_homogeneous:
            counts = {c: r.num_edges for c, r in self._relations.items()}
            return (f"Graph(num_nodes={self._num_src_nodes}, "
                    f"num_edges={counts}, device={self.device})")
        return (f"Graph(num_nodes={self.num_nodes()}, "
                f"num_edges={self.num_edges()}, device={self.device})")


def _delegate_transform(name, module="transforms.functional"):
    def method(self, *args, **kwargs):
        import importlib

        mod = importlib.import_module(f".{module}", package=__package__)
        return getattr(mod, name)(self, *args, **kwargs)

    method.__name__ = name
    method.__doc__ = (f"Method form of ``{module}.{name}`` (reference "
                      "``heterograph.py``).")
    return method


for _name in ("add_edges", "remove_edges", "add_nodes", "remove_nodes",
              "line_graph", "to_simple", "add_self_loop",
              "remove_self_loop", "khop_graph"):
    setattr(Graph, _name, _delegate_transform(_name))
Graph.sample_neighbors = _delegate_transform("sample_neighbors",
                                             "sampling.neighbor")
Graph.global_uniform_negative_sampling = _delegate_transform(
    "global_uniform_negative_sampling", "sampling.negative")


def ragged_gather(indptr, eids, seeds):
    """All of the seeds' CSR/CSC runs ``eids[indptr[s]:indptr[s + 1]]``,
    seed after seed, as one host array (int64 when empty)."""
    if seeds.size == 0:
        return np.zeros(0, np.int64)
    starts = indptr[seeds]
    lens = indptr[seeds + 1] - starts
    total = int(lens.sum())
    if total == 0:
        return np.zeros(0, np.int64)
    reps = np.repeat(starts - np.concatenate([[0], np.cumsum(lens)[:-1]]),
                     lens)
    return np.asarray(eids)[np.arange(total) + reps]


def unique_first_occurrence(cat: np.ndarray):
    """The distinct values of the int64 ids ``cat`` in order of first
    occurrence, and each element's index among them (host arrays). Sorts
    and scatters with torch on the host: several threads, where
    ``np.unique`` takes one."""
    ids = torch.from_numpy(np.ascontiguousarray(cat, np.int64).reshape(-1))
    uniq, inv = torch.unique(ids, return_inverse=True)
    first = torch.full(uniq.shape, ids.shape[0], dtype=torch.int64)
    first.scatter_reduce_(0, inv, torch.arange(ids.shape[0]), reduce="amin")
    order = torch.sort(first)[1]  # first occurrences are distinct
    rank = torch.empty_like(order)
    rank[order] = torch.arange(order.shape[0])
    return uniq[order].numpy(), rank[inv].numpy()


def with_dense_plans(r: Relation, dense_attn: bool | str = "auto",
                     dense_attn_max_cells: int = 16_000_000,
                     bitmap: bool | str = "auto",
                     bitmap_max_bytes: int = 2 << 30,
                     bitmap_min_density: float = 5e-4) -> Relation:
    """``r`` with the dense adjacency mask and the bitmap plan that
    ``Graph.with_spmm_plans`` attaches besides the hub and shell plans
    (reference ``graph.py:1165-1180``)."""
    from .ops.bitmap_spmm import bitmap_bytes, build_bitmap_plan
    from .ops.dense_attn import build_dense_adj

    cells = r.num_src * r.num_dst
    if dense_attn is True or dense_attn == "auto":
        da = build_dense_adj(r, max_cells=dense_attn_max_cells)
        if da is not None:
            r = r.with_dense_adj(da)
    want_bitmap = bitmap is True or (
        bitmap == "auto" and cells > 0
        and r.num_edges / cells >= bitmap_min_density
        and bitmap_bytes(r.num_src, r.num_dst, False) <= bitmap_max_bytes * 2)
    if want_bitmap:
        bp = build_bitmap_plan(r, max_bytes=bitmap_max_bytes)
        if bp is not None:
            r = r.with_bitmap_plan(bp)
    return r


class _LocalScope:
    def __init__(self, graph: Graph):
        self._graph = graph

    def __enter__(self):
        g = self._graph
        self._saved = (g._node_frames, g._dst_frames, g._edge_frames)
        g._node_frames = {nt: dict(f) for nt, f in g._node_frames.items()}
        g._dst_frames = (g._node_frames if not g._is_block else
                         {nt: dict(f) for nt, f in g._dst_frames.items()})
        g._edge_frames = {et: dict(f) for et, f in g._edge_frames.items()}
        return g

    def __exit__(self, *exc):
        g = self._graph
        g._node_frames, g._dst_frames, g._edge_frames = self._saved
        return False
