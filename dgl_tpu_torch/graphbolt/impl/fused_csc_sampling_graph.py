"""FusedCSCSamplingGraph: the GraphBolt sampling-graph object (counterpart
of ``dgl_tpu/graphbolt/impl/fused_csc_sampling_graph.py``; reference
``python/dgl/graphbolt/impl/fused_csc_sampling_graph.py``).

Sampling is host work that feeds the device's minibatches, so the
container is a CSC in numpy: vectorised picks drawn from
``np.random.default_rng(seed)`` as the reference draws them (the same seed
gives the same edges), heterogeneous graphs through the node-type-offset
encoding, per-edge probabilities through ``edge_attributes``. Device work
never sees this object; the pipeline's stages build the blocks.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from ...base import DGLError
from ...graph import _asnumpy

__all__ = [
    "CSCFormatBase",
    "SampledSubgraphImpl",
    "FusedCSCSamplingGraph",
    "fused_csc_sampling_graph",
    "from_dglgraph",
]


@dataclass
class CSCFormatBase:
    """(reference ``base.py`` CSCFormatBase): a compacted CSC pair."""

    indptr: np.ndarray
    indices: np.ndarray

    def __repr__(self):
        return (f"CSCFormatBase(indptr={self.indptr.shape}, "
                f"indices={self.indices.shape})")


@dataclass
class SampledSubgraphImpl:
    """(reference ``impl/sampled_subgraph_impl.py``): one sampled layer.

    ``sampled_csc``: seeds as columns, picked in-neighbors as rows (row ids
    are ORIGINAL graph ids). ``original_edge_ids`` index the parent graph's
    edges; ``original_column_node_ids`` are the seeds."""

    sampled_csc: CSCFormatBase
    original_column_node_ids: np.ndarray
    original_row_node_ids: Optional[np.ndarray] = None
    original_edge_ids: Optional[np.ndarray] = None
    type_per_edge: Optional[np.ndarray] = None

    def num_sampled_edges(self) -> int:
        return int(self.sampled_csc.indices.shape[0])


class FusedCSCSamplingGraph:
    """(reference ``impl/fused_csc_sampling_graph.py:138``)."""

    def __init__(
        self,
        csc_indptr: np.ndarray,
        indices: np.ndarray,
        node_type_offset: Optional[np.ndarray] = None,
        type_per_edge: Optional[np.ndarray] = None,
        node_type_to_id: Optional[Dict[str, int]] = None,
        edge_type_to_id: Optional[Dict[str, int]] = None,
        node_attributes: Optional[Dict[str, np.ndarray]] = None,
        edge_attributes: Optional[Dict[str, np.ndarray]] = None,
        edge_ids: Optional[np.ndarray] = None,
    ):
        self.csc_indptr = np.asarray(csc_indptr, np.int64)
        self.indices = np.asarray(indices, np.int64)
        self.node_type_offset = (
            None if node_type_offset is None
            else np.asarray(node_type_offset, np.int64)
        )
        self.type_per_edge = (
            None if type_per_edge is None
            else np.asarray(type_per_edge)
        )
        self.node_type_to_id = node_type_to_id
        self.edge_type_to_id = edge_type_to_id
        self.node_attributes = node_attributes or {}
        self.edge_attributes = edge_attributes or {}
        # per-CSC-position original edge id (identity when built raw)
        self._eids = (
            np.arange(self.indices.shape[0], dtype=np.int64)
            if edge_ids is None else np.asarray(edge_ids, np.int64)
        )
        # lazy per-graph caches: prob cumsums and per-type edge masks
        # (per-call O(E) host passes would dominate minibatch epochs on
        # large graphs)
        self._prob_cumsum = {}
        self._type_masks = None

    def _cumsum_of(self, probs) -> np.ndarray:
        """The running sum of ``probs`` in CSC order, a leading 0 first.
        Kept for a tensor while it is the same object at the same version
        (an in-place write bumps ``_version`` and the sum is taken again);
        a numpy array has no version, so its sum is taken every call."""
        if not isinstance(probs, torch.Tensor):
            return np.concatenate(([0.0], np.cumsum(
                np.asarray(probs)[self._eids])))
        key = (id(probs), probs._version, probs.data_ptr())
        hit = self._prob_cumsum.get(id(probs))
        if hit is None or hit[0] is not probs or hit[1] != key:
            hit = (probs, key, np.concatenate(([0.0], np.cumsum(
                _asnumpy(probs)[self._eids]))))
            self._prob_cumsum[id(probs)] = hit
        return hit[2]

    # -- metadata -----------------------------------------------------------

    @property
    def total_num_nodes(self) -> int:
        return int(self.csc_indptr.shape[0] - 1)

    @property
    def total_num_edges(self) -> int:
        return int(self.indices.shape[0])

    def num_nodes(self, ntype: Optional[str] = None) -> int:
        if ntype is None:
            return self.total_num_nodes
        if self.node_type_offset is None or self.node_type_to_id is None:
            raise DGLError("homogeneous graph has no node types")
        i = self.node_type_to_id[ntype]
        return int(self.node_type_offset[i + 1] - self.node_type_offset[i])

    @property
    def num_edges(self) -> int:
        return self.total_num_edges

    def __repr__(self):
        return (f"FusedCSCSamplingGraph(num_nodes={self.total_num_nodes}, "
                f"num_edges={self.total_num_edges})")

    # -- sampling -----------------------------------------------------------

    def _pick(self, nodes, fanout: int, replace: bool, probs, rng):
        """Vectorized rowwise pick: up to ``fanout`` in-edges per seed
        (reference ``rowwise_pick.h:27`` semantics: deg <= fanout keeps all
        edges; -1 keeps everything)."""
        nodes = np.asarray(nodes, np.int64)
        starts = self.csc_indptr[nodes]
        degs = self.csc_indptr[nodes + 1] - starts
        if fanout < 0:  # full neighborhood
            counts = degs
            pos = _ragged_arange(counts)
            sel = np.repeat(starts, counts) + pos
        elif replace:
            counts = np.where(degs > 0, fanout, 0)
            safe = np.maximum(np.repeat(degs, counts), 1)
            draw_start = np.repeat(starts, counts)
            u = rng.random(int(counts.sum()))
            if probs is None:
                r = (u * safe).astype(np.int64)
            else:
                # per-draw inverse-CDF over the row's weights via the global
                # cumulative sum (reference rowwise_sampling.cc semantics),
                # cached per probs array across calls
                cp = self._cumsum_of(probs)
                base = cp[draw_start]
                rowsum = cp[draw_start + safe] - base
                tgt = base + u * np.maximum(rowsum, 1e-300)
                r = np.searchsorted(cp, tgt, side="left") - 1 - draw_start
                r = np.clip(r, 0, safe - 1)
            sel = draw_start + r
        else:
            counts = np.minimum(degs, fanout)
            # per-seed partial permutation via random keys (one rng call)
            pos = _ragged_arange(degs)
            owner = np.repeat(np.arange(nodes.shape[0]), degs)
            keys = rng.random(pos.shape[0])
            if probs is not None:
                p = probs[self._eids[np.repeat(starts, degs) + pos]]
                # weighted sampling w/o replacement: exponential sort trick
                with np.errstate(divide="ignore"):
                    keys = np.where(p > 0, -np.log(keys) / np.maximum(p, 1e-38),
                                    np.inf)
            order = np.lexsort((keys, owner))
            edge_pos = (np.repeat(starts, degs) + pos)[order]
            rank = _ragged_arange(degs)
            keep = rank < np.repeat(counts, degs)
            sel = edge_pos[keep]
        indptr = np.concatenate(([0], np.cumsum(counts)))
        return indptr.astype(np.int64), sel

    def sample_neighbors(
        self,
        nodes,
        fanouts,
        replace: bool = False,
        probs_name: Optional[str] = None,
        seed: Optional[int] = None,
    ) -> SampledSubgraphImpl:
        """(reference ``fused_csc_sampling_graph.py:584``). ``fanouts`` is a
        per-etype sequence (or a single int); homogeneous graphs use
        ``fanouts[0]``."""
        if isinstance(fanouts, (int, np.integer)):
            fanouts = [int(fanouts)]
        probs = (self.edge_attributes[probs_name]
                 if probs_name else None)
        if probs is not None and not replace:
            probs = _asnumpy(probs)
        rng = np.random.default_rng(seed)
        nodes = np.asarray(nodes, np.int64)
        if self.type_per_edge is None or len(fanouts) == 1:
            indptr, sel = self._pick(nodes, int(fanouts[0]), replace,
                                     probs, rng)
        else:
            # hetero: pick per edge type with its own fanout, then merge in
            # CSC position order per seed
            if self._type_masks is None:
                self._type_masks = {}
            sels, owners = [], []
            for t, f in enumerate(fanouts):
                mask = self._type_masks.get(t)
                if mask is None:
                    mask = np.asarray(self.type_per_edge == t)
                    self._type_masks[t] = mask
                o, s_ = self._pick_masked(nodes, int(f), replace, probs,
                                          rng, mask)
                sels.append(s_)
                owners.append(o)
            sel = np.concatenate(sels)
            owner = np.concatenate(owners)
            order = np.lexsort((sel, owner))
            sel = sel[order]
            counts = np.bincount(owner, minlength=nodes.shape[0])
            indptr = np.concatenate(([0], np.cumsum(counts)))
        return SampledSubgraphImpl(
            sampled_csc=CSCFormatBase(indptr, self.indices[sel]),
            original_column_node_ids=nodes,
            original_edge_ids=self._eids[sel],
            type_per_edge=(None if self.type_per_edge is None
                           else self.type_per_edge[sel]),
        )

    def _pick_masked(self, nodes, fanout, replace, probs, rng, emask):
        starts = self.csc_indptr[nodes]
        degs = self.csc_indptr[nodes + 1] - starts
        pos = _ragged_arange(degs)
        owner = np.repeat(np.arange(nodes.shape[0]), degs)
        epos = np.repeat(starts, degs) + pos
        ok = emask[epos]
        if replace and fanout >= 0:
            # fanout draws WITH repetition per seed among its ok edges
            tdeg = np.bincount(owner, weights=ok.astype(np.int64),
                               minlength=nodes.shape[0]).astype(np.int64)
            counts = np.where(tdeg > 0, fanout, 0)
            # rank of ok edges within each owner (0..tdeg-1), built by
            # cumulative count over the ok positions
            okc = np.cumsum(ok) - 1
            okc_start = np.concatenate(([0], np.cumsum(tdeg)))[:-1]
            # map (owner, j-th draw) -> a uniformly random ok edge
            draw_owner = np.repeat(np.arange(nodes.shape[0]), counts)
            u = rng.random(int(counts.sum()))
            jth = (u * np.maximum(tdeg[draw_owner], 1)).astype(np.int64)
            ok_epos = epos[ok]
            if probs is not None:
                p = _asnumpy(probs)[self._eids[ok_epos]]
                cp = np.concatenate(([0.0], np.cumsum(p)))
                base = cp[okc_start[draw_owner]]
                rowsum = (cp[okc_start[draw_owner]
                             + tdeg[draw_owner]] - base)
                tgt = base + u * np.maximum(rowsum, 1e-300)
                jth = (np.searchsorted(cp, tgt, side="left") - 1
                       - okc_start[draw_owner])
                jth = np.clip(jth, 0, np.maximum(tdeg[draw_owner] - 1, 0))
            sel = ok_epos[okc_start[draw_owner] + jth]
            return draw_owner, sel
        keys = rng.random(pos.shape[0])
        if probs is not None:
            p = probs[self._eids[epos]]
            with np.errstate(divide="ignore"):
                keys = np.where(p > 0, -np.log(keys) / np.maximum(p, 1e-38),
                                np.inf)
        keys = np.where(ok, keys, np.inf)
        order = np.lexsort((keys, owner))
        epos_s = epos[order]
        ok_s = ok[order]
        rank = _ragged_arange(degs)
        tdeg = np.bincount(owner, weights=ok.astype(np.int64),
                           minlength=nodes.shape[0]).astype(np.int64)
        cnt = (np.minimum(tdeg, fanout) if fanout >= 0 else tdeg)
        keep = (rank < np.repeat(cnt, degs)) & ok_s
        return owner[order][keep], epos_s[keep]

    def in_subgraph(self, nodes) -> SampledSubgraphImpl:
        """All in-edges of the seeds (reference
        ``impl/in_subgraph_sampler.py`` / ``fused_csc_sampling_graph.py``
        ``in_subgraph``)."""
        indptr, sel = self._pick(np.asarray(nodes, np.int64), -1, False,
                                 None, np.random.default_rng(0))
        return SampledSubgraphImpl(
            sampled_csc=CSCFormatBase(indptr, self.indices[sel]),
            original_column_node_ids=np.asarray(nodes, np.int64),
            original_edge_ids=self._eids[sel],
            type_per_edge=(None if self.type_per_edge is None
                           else self.type_per_edge[sel]),
        )

    def temporal_sample_neighbors(
        self,
        nodes,
        input_nodes_timestamp,
        fanouts,
        replace: bool = False,
        node_timestamp_attr_name: Optional[str] = None,
        edge_timestamp_attr_name: Optional[str] = None,
        seed: Optional[int] = None,
    ) -> SampledSubgraphImpl:
        """Only neighbors/edges no newer than each seed's timestamp
        (reference ``impl/temporal_neighbor_sampler.py`` +
        ``fused_csc_sampling_graph.py:738``)."""
        if isinstance(fanouts, (int, np.integer)):
            fanouts = [int(fanouts)]
        nodes = np.asarray(nodes, np.int64)
        ts = _asnumpy(input_nodes_timestamp)
        starts = self.csc_indptr[nodes]
        degs = self.csc_indptr[nodes + 1] - starts
        pos = _ragged_arange(degs)
        owner = np.repeat(np.arange(nodes.shape[0]), degs)
        epos = np.repeat(starts, degs) + pos
        ok = np.ones(epos.shape[0], bool)
        if node_timestamp_attr_name is not None:
            nts = _asnumpy(self.node_attributes[node_timestamp_attr_name])
            ok &= nts[self.indices[epos]] <= ts[owner]
        if edge_timestamp_attr_name is not None:
            ets = _asnumpy(self.edge_attributes[edge_timestamp_attr_name])
            ok &= ets[self._eids[epos]] <= ts[owner]
        rng = np.random.default_rng(seed)
        tdeg = np.bincount(owner, weights=ok.astype(np.int64),
                           minlength=nodes.shape[0]).astype(np.int64)
        f = int(fanouts[0])
        if replace and f >= 0:
            counts = np.where(tdeg > 0, f, 0)
            okc_start = np.concatenate(([0], np.cumsum(tdeg)))[:-1]
            draw_owner = np.repeat(np.arange(nodes.shape[0]), counts)
            u = rng.random(int(counts.sum()))
            jth = (u * np.maximum(tdeg[draw_owner], 1)).astype(np.int64)
            sel = epos[ok][okc_start[draw_owner] + jth]
            indptr = np.concatenate(([0], np.cumsum(counts)))
            return SampledSubgraphImpl(
                sampled_csc=CSCFormatBase(indptr.astype(np.int64),
                                          self.indices[sel]),
                original_column_node_ids=nodes,
                original_edge_ids=self._eids[sel],
            )
        keys = np.where(ok, rng.random(epos.shape[0]), np.inf)
        order = np.lexsort((keys, owner))
        rank = _ragged_arange(degs)
        cnt = np.minimum(tdeg, f) if f >= 0 else tdeg
        keep = (rank < np.repeat(cnt, degs)) & ok[order]
        # lexsort's primary key is `owner`, so the kept picks are already
        # grouped per seed in `nodes` order — the CSC column order
        sel = epos[order][keep]
        counts = np.bincount(owner[order][keep],
                             minlength=nodes.shape[0]).astype(np.int64)
        indptr = np.concatenate(([0], np.cumsum(counts)))
        return SampledSubgraphImpl(
            sampled_csc=CSCFormatBase(indptr.astype(np.int64),
                                      self.indices[sel]),
            original_column_node_ids=nodes,
            original_edge_ids=self._eids[sel],
        )

    # -- conversion ---------------------------------------------------------

    def to_dglgraph(self, device="cuda"):
        """Materialise as a :class:`dgl_tpu_torch.Graph` (src->dst COO) on
        ``device``."""
        from ... import convert

        n = self.total_num_nodes
        dst = np.repeat(np.arange(n, dtype=np.int64),
                        np.diff(self.csc_indptr))
        return convert.graph((self.indices, dst), num_nodes=n,
                             device=device)


def _ragged_arange(counts):
    """[0..c0), [0..c1), ... concatenated (vectorized)."""
    counts = np.asarray(counts, np.int64)
    total = int(counts.sum())
    if total == 0:
        return np.zeros(0, np.int64)
    ends = np.cumsum(counts)
    out = np.arange(total, dtype=np.int64)
    out -= np.repeat(ends - counts, counts)
    return out


def fused_csc_sampling_graph(
    csc_indptr,
    indices,
    node_type_offset=None,
    type_per_edge=None,
    node_type_to_id=None,
    edge_type_to_id=None,
    node_attributes=None,
    edge_attributes=None,
) -> FusedCSCSamplingGraph:
    """Factory with the reference's signature
    (``fused_csc_sampling_graph.py:38``)."""
    return FusedCSCSamplingGraph(
        csc_indptr, indices, node_type_offset, type_per_edge,
        node_type_to_id, edge_type_to_id, node_attributes, edge_attributes,
    )


def from_dglgraph(g, is_homogeneous: bool = True) -> FusedCSCSamplingGraph:
    """Build from a :class:`dgl_tpu_torch.Graph` (reference
    ``fused_csc_sampling_graph.py`` ``from_dglgraph``), from the relation's
    host copies of its CSC (no device read where the graph was built on
    the host)."""
    rel = g._relation(None)
    indptr, indices, eids, dst = rel.host_arrays(
        "csc_indptr", "csc_indices", "csc_eids", "csc_dst")
    indptr = indptr[: rel.num_dst + 1]
    # drop padding (graphs padded to static shapes carry dst==num_dst /
    # src==num_src past the real edges) and rebuild from the dst expansion
    real = (indices < rel.num_src) & (dst < rel.num_dst)
    if not real.all():
        keep = np.nonzero(real)[0]
        counts = np.bincount(dst[keep], minlength=rel.num_dst)
        indptr = np.concatenate(([0], np.cumsum(counts)))
        indices = indices[keep]
        eids = eids[keep]
    return FusedCSCSamplingGraph(indptr, indices, edge_ids=eids)


def _shm_write(name: str, arrays: dict):
    """Serialize named int64/float arrays into one POSIX shared-memory
    block with a small JSON header."""
    import json
    from multiprocessing import shared_memory

    header = {}
    offset = 0
    blobs = []
    for key, arr in arrays.items():
        if arr is None:
            continue
        arr = np.ascontiguousarray(arr)
        header[key] = {
            "dtype": str(arr.dtype), "shape": list(arr.shape),
            "offset": offset,
        }
        blobs.append(arr)
        offset += arr.nbytes
    hdr = json.dumps(header).encode()
    total = 8 + len(hdr) + offset
    try:
        shm = shared_memory.SharedMemory(name=name, create=True, size=total)
    except FileExistsError:
        old = shared_memory.SharedMemory(name=name)
        old.close()
        old.unlink()
        shm = shared_memory.SharedMemory(name=name, create=True, size=total)
    shm.buf[:8] = len(hdr).to_bytes(8, "little")
    shm.buf[8:8 + len(hdr)] = hdr
    base = 8 + len(hdr)
    for key, arr in zip([k for k in header], blobs):
        o = base + header[key]["offset"]
        shm.buf[o:o + arr.nbytes] = arr.tobytes()
    return shm


def _shm_read(name: str):
    import json
    from multiprocessing import shared_memory

    shm = shared_memory.SharedMemory(name=name)
    hlen = int.from_bytes(bytes(shm.buf[:8]), "little")
    header = json.loads(bytes(shm.buf[8:8 + hlen]).decode())
    base = 8 + hlen
    out = {}
    for key, spec in header.items():
        o = base + spec["offset"]
        dt = np.dtype(spec["dtype"])
        count = int(np.prod(spec["shape"])) if spec["shape"] else 1
        # copy the bytes out first: a live frombuffer view would keep the
        # shm buffer exported and make close() raise BufferError
        raw = bytes(shm.buf[o:o + count * dt.itemsize])
        out[key] = np.frombuffer(raw, dtype=dt).reshape(spec["shape"])
    shm.close()
    return out


def load_from_shared_memory(shared_memory_name: str) -> FusedCSCSamplingGraph:
    """Attach a graph previously published with
    :meth:`FusedCSCSamplingGraph.copy_to_shared_memory` (reference
    ``fused_csc_sampling_graph.py:1684``) — the reference's server/client
    shared-partition trick, over POSIX shm."""
    arrays = _shm_read(shared_memory_name)
    return FusedCSCSamplingGraph(
        arrays["csc_indptr"],
        arrays["indices"],
        node_type_offset=arrays.get("node_type_offset"),
        type_per_edge=arrays.get("type_per_edge"),
        edge_ids=arrays.get("edge_ids"),
    )


def _copy_to_shared_memory(self, shared_memory_name: str):
    """Publish the structure arrays into POSIX shared memory (reference
    ``fused_csc_sampling_graph.py:1448``); returns self. The shm block
    outlives this process until unlinked."""
    self._shm = _shm_write(shared_memory_name, {
        "csc_indptr": self.csc_indptr,
        "indices": self.indices,
        "node_type_offset": self.node_type_offset,
        "type_per_edge": self.type_per_edge,
        "edge_ids": self._eids,
    })
    return self


FusedCSCSamplingGraph.copy_to_shared_memory = _copy_to_shared_memory

__all__ += ["load_from_shared_memory"]
