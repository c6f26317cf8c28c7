"""Graph object of the port (counterpart of ``dgl_tpu/graph.py``).

A :class:`Relation` holds one canonical edge type as COO + CSR + CSC index
tensors, built once on the host with numpy and moved to the graph's device.
Padded edges (beyond ``num_edges``) point at the virtual rows
``num_src``/``num_dst``, as in the reference. A :class:`Graph` maps
canonical edge types to relations and keeps node and edge features in plain
dicts behind ``ndata``/``srcdata``/``dstdata``/``edata`` views.

Ported: the homogeneous graph (one node type, one edge type) and the
message-flow-graph block (``is_block=True``, reference ``create_block``),
whose destination nodes have a frame of their own.
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
        The sorts are stable numpy argsorts: ties keep edge-id order.
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
            # +1: the padding row; padded edges sort to the end
            order = np.argsort(major, kind="stable").astype(np_id)
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
        arrays = {f: getattr(self, f).to(device) for f in Relation.ARRAY_FIELDS}
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

    def in_degrees(self) -> torch.Tensor:
        return self.csc_indptr[1:] - self.csc_indptr[:-1]

    def out_degrees(self) -> torch.Tensor:
        return self.csr_indptr[1:] - self.csr_indptr[:-1]

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
# Data views (ndata / srcdata / dstdata / edata)
# ---------------------------------------------------------------------------


class _FrameView(Mapping):
    """Dict view of one feature frame with a first-dimension check."""

    __slots__ = ("_frame", "_rows", "_what")

    def __init__(self, frame: Dict[str, Any], rows: Tuple[int, ...], what):
        self._frame = frame
        self._rows = rows
        self._what = what

    def __getitem__(self, key):
        return self._frame[key]

    def __setitem__(self, key, value):
        if value.shape[0] not in self._rows:
            raise DGLError(f"Feature first dim {value.shape[0]} != number "
                           f"of {self._what} {self._rows[0]}")
        self._frame[key] = value

    def update(self, other):
        for key, value in dict(other).items():
            self[key] = value

    def __iter__(self):
        return iter(self._frame)

    def __len__(self):
        return len(self._frame)

    def __repr__(self):
        return repr(dict(self._frame))


# ---------------------------------------------------------------------------
# Graph
# ---------------------------------------------------------------------------


class Graph:
    """Homogeneous graph or block: one node type, one relation, feature
    frames.

    Counterpart of ``dgl_tpu.graph.Graph`` (reference ``DGLGraph``). A
    block (``is_block=True``, a message-flow graph) has separate source
    and destination node spaces: ``srcdata`` (also ``ndata``) holds
    ``num_src_nodes()`` rows, ``dstdata`` ``num_dst_nodes()`` rows in a
    frame of its own. On a graph both views share one frame.
    """

    def __init__(self, relations: Dict[CanonicalEtype, Relation],
                 num_src_nodes: Dict[str, int],
                 num_dst_nodes: Optional[Dict[str, int]] = None,
                 is_block: bool = False):
        if len(relations) != 1 or len(num_src_nodes) != 1:
            raise NotImplementedError(
                "heterogeneous graphs are ported in a later slice "
                "(ROADMAP queue A1)")
        self._relations = dict(relations)
        self._canonical_etypes = tuple(self._relations)
        self._num_src_nodes = dict(num_src_nodes)
        self._num_dst_nodes = dict(num_dst_nodes if num_dst_nodes is not None
                                   else num_src_nodes)
        if self._num_dst_nodes.keys() != self._num_src_nodes.keys():
            raise NotImplementedError(
                "blocks between node types: heterogeneous graphs "
                "(ROADMAP queue A1)")
        self._is_block = bool(is_block)
        self._node_frames: Dict[str, Dict[str, Any]] = {}
        # a block's destination nodes have their own frames; a graph's
        # are its node frames
        self._dst_frames = {} if self._is_block else self._node_frames
        self._edge_frames: Dict[CanonicalEtype, Dict[str, Any]] = {}
        for (st, _, dt) in self._relations:
            if st not in self._num_src_nodes or dt not in self._num_dst_nodes:
                raise DGLError(f"Unknown node type in relation {st}->{dt}")

    # -- schema ------------------------------------------------------------

    @property
    def is_block(self) -> bool:
        return self._is_block

    @property
    def ntypes(self):
        return list(self._num_src_nodes)

    @property
    def idtype(self):
        return self._relation().src.dtype

    @property
    def device(self) -> torch.device:
        return self._relation().device

    def to_canonical_etype(self, etype) -> CanonicalEtype:
        if etype is None:
            return self._canonical_etypes[0]
        if isinstance(etype, tuple):
            if tuple(etype) not in self._relations:
                raise DGLError(f"Unknown canonical etype {etype}")
            return tuple(etype)
        matches = [c for c in self._canonical_etypes if c[1] == etype]
        if not matches:
            raise DGLError(f"Unknown edge type {etype!r}")
        return matches[0]

    def _relation(self, etype=None) -> Relation:
        return self._relations[self.to_canonical_etype(etype)]

    # -- counts --------------------------------------------------------------

    def num_nodes(self, ntype: Optional[str] = None) -> int:
        """The node count; on a block the source nodes', which hold the
        destination nodes first."""
        return self._num_src_nodes[ntype or self.ntypes[0]]

    def num_src_nodes(self, ntype: Optional[str] = None) -> int:
        return self.num_nodes(ntype)

    def num_dst_nodes(self, ntype: Optional[str] = None) -> int:
        return self._num_dst_nodes[ntype or self.ntypes[0]]

    def num_edges(self, etype=None) -> int:
        return self._relation(etype).num_edges

    # -- data views ----------------------------------------------------------

    @property
    def ndata(self):
        return _FrameView(self._node_frames.setdefault(self.ntypes[0], {}),
                          (self.num_nodes(),), "nodes")

    srcdata = ndata

    @property
    def dstdata(self):
        return _FrameView(self._dst_frames.setdefault(self.ntypes[0], {}),
                          (self.num_dst_nodes(),), "dst nodes")

    @property
    def edata(self):
        rel = self._relation()
        frame = self._edge_frames.setdefault(self._canonical_etypes[0], {})
        return _FrameView(frame, (rel.num_edges, rel.num_edges_padded),
                          "edges")

    # -- structure queries ---------------------------------------------------

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
        """A copy whose relation carries the reference's SpMM plans.

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

    def __repr__(self):
        if self._is_block:
            return (f"Block(num_src_nodes={self.num_src_nodes()}, "
                    f"num_dst_nodes={self.num_dst_nodes()}, "
                    f"num_edges={self.num_edges()}, device={self.device})")
        return (f"Graph(num_nodes={self.num_nodes()}, "
                f"num_edges={self.num_edges()}, device={self.device})")


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
