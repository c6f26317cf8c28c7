"""Random walks (counterpart of ``dgl_tpu/sampling/randomwalks.py``;
reference ``python/dgl/sampling/randomwalks.py:11``, C++
``src/graph/sampling/randomwalks/``).

Walks are (num_seeds, length + 1) traces, -1 after a walk ends. The
uniform walk over one edge type runs in ``csrc/host_ops.cpp``; metapath,
weighted and restarting walks and node2vec run the reference's host loop
on the same numpy draws. Traces come back as int64 on ``g``'s device.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from .. import _host
from ..base import DGLError
from ..graph import Graph, _asnumpy
from .neighbor import _put

__all__ = ["random_walk", "node2vec_random_walk", "pack_traces"]


def _walk_host(g: Graph, nodes, *, metapath=None, length=None, prob=None,
               restart_prob=None, return_eids=False, seed=None):
    """``random_walk``'s numpy (traces, types, eids); eids is None on the
    uniform path, which does not record them."""
    rng = np.random.default_rng(seed)
    nodes = np.atleast_1d(_asnumpy(nodes)).astype(np.int64)
    if (metapath is None and length is not None and prob is None
            and restart_prob is None and not return_eids
            and len(g.canonical_etypes) == 1):
        indptr, indices = _host.int64_arrays(g._relation(None), "csr_indptr",
                                             "csr_indices")
        traces = _host.random_walk_uniform(
            indptr, indices, nodes, length,
            int(np.random.default_rng(seed).integers(2**63)))
        return traces, np.zeros(length + 1, dtype=np.int64), None
    if metapath is None:
        if len(g.canonical_etypes) > 1:
            raise DGLError("metapath required for heterographs")
        if length is None:
            raise DGLError("length required when metapath is None")
        metapath = [g.canonical_etypes[0]] * length
    cets = [g.to_canonical_etype(et) for et in metapath]
    for a, b in zip(cets[:-1], cets[1:]):
        if a[2] != b[0]:
            raise DGLError(f"metapath discontinuity: {a} -> {b}")
    ntype_ids = {nt: i for i, nt in enumerate(g.ntypes)}
    types = np.array([ntype_ids[nt] for nt in
                      [cets[0][0]] + [c[2] for c in cets]], dtype=np.int64)
    n, L = nodes.shape[0], len(cets)
    traces = np.full((n, L + 1), -1, dtype=np.int64)
    eids = np.full((n, L), -1, dtype=np.int64)
    traces[:, 0] = nodes
    csr = {cet: g._relations[cet].host_arrays("csr_indptr", "csr_indices",
                                              "csr_eids")
           for cet in set(cets)}
    probs = {}
    if prob is not None:
        for cet in set(cets):
            if prob in g._edge_frames.get(cet, {}):
                probs[cet] = _asnumpy(g._edge_frames[cet][prob]).astype(
                    np.float64)
    for i in range(n):
        cur = int(nodes[i])
        for step, cet in enumerate(cets):
            if restart_prob is not None and rng.random() < restart_prob:
                break
            indptr, indices, es = csr[cet]
            lo, hi = int(indptr[cur]), int(indptr[cur + 1])
            deg = hi - lo
            if deg == 0:
                break
            if cet in probs:
                p = probs[cet][es[lo:hi]]
                tot = p.sum()
                if tot <= 0:
                    break
                j = rng.choice(deg, p=p / tot)
            else:
                j = rng.integers(0, deg)
            cur = int(indices[lo + j])
            traces[i, step + 1] = cur
            eids[i, step] = es[lo + j]
    return traces, types, eids


def random_walk(g: Graph, nodes, *, metapath: Optional[Sequence] = None,
                length: Optional[int] = None, prob: Optional[str] = None,
                restart_prob: Optional[float] = None,
                return_eids: bool = False, seed: Optional[int] = None):
    """Walks from each of ``nodes`` (reference ``randomwalks.py:11``):
    ``length`` steps over the one edge type, or one step per edge type of
    ``metapath``; ``prob`` weights the steps by an edge feature and
    ``restart_prob`` ends a walk before a step with that chance. Returns
    ``(traces, types)``, with ``return_eids`` also the (num_seeds,
    steps) edge ids (-1 past the end), int64 on ``g``'s device."""
    traces, types, eids = _walk_host(
        g, nodes, metapath=metapath, length=length, prob=prob,
        restart_prob=restart_prob, return_eids=return_eids, seed=seed)
    out = (_put(traces, g.device), _put(types, g.device))
    return out + (_put(eids, g.device),) if return_eids else out


def node2vec_random_walk(g: Graph, nodes, p: float, q: float,
                         walk_length: int, prob: Optional[str] = None,
                         seed: Optional[int] = None) -> torch.Tensor:
    """node2vec's second-order walk (reference ``node2vec_randomwalk.py:
    11``): from the previous node ``t``, a step back weighs ``1/p``, to a
    neighbour of ``t`` 1 and elsewhere ``1/q``. Traces as int64 on
    ``g``'s device."""
    rng = np.random.default_rng(seed)
    nodes = np.atleast_1d(_asnumpy(nodes)).astype(np.int64)
    indptr, indices = g._relation(None).host_arrays("csr_indptr",
                                                    "csr_indices")
    n = nodes.shape[0]
    traces = np.full((n, walk_length + 1), -1, dtype=np.int64)
    traces[:, 0] = nodes
    for i in range(n):
        cur, prev = int(nodes[i]), -1
        for step in range(walk_length):
            nbrs = indices[indptr[cur]:indptr[cur + 1]]
            if nbrs.size == 0:
                break
            if prev < 0:
                nxt = int(nbrs[rng.integers(0, nbrs.size)])
            else:
                prev_nbrs = set(map(int, indices[indptr[prev]:
                                                 indptr[prev + 1]]))
                w = np.array([1.0 / p if int(x) == prev else
                              1.0 if int(x) in prev_nbrs else 1.0 / q
                              for x in nbrs], np.float64)
                w /= w.sum()
                nxt = int(nbrs[rng.choice(nbrs.size, p=w)])
            traces[i, step + 1] = nxt
            prev, cur = cur, nxt
    return _put(traces, g.device)


def pack_traces(traces, types):
    """Concatenate -1-padded traces (reference ``pack_traces``): returns
    ``(vids, vtypes, lengths, offsets)``, int64 on the traces' device."""
    device = traces.device if isinstance(traces, torch.Tensor) else "cpu"
    traces, types = _asnumpy(traces), _asnumpy(types)
    lengths = (traces >= 0).sum(axis=1).astype(np.int64)
    offsets = np.concatenate([[0], np.cumsum(lengths)[:-1]]).astype(
        np.int64)[:traces.shape[0]]
    keep = np.arange(traces.shape[1])[None, :] < lengths[:, None]
    vids = traces[keep].astype(np.int64)
    vtypes = np.broadcast_to(types, traces.shape)[keep].astype(np.int64)
    return tuple(_put(a, device) for a in (vids, vtypes, lengths, offsets))
