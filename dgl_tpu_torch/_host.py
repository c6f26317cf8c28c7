"""Build, load and call the host library (``csrc/host_ops.cpp``): the
samplers' picks, the partitioner's matching, aggregation and k-way gains,
and the batched row reads of the out-of-core feature store.

``csrc/host_ops.cpp`` is framework-free C++ shared by both packages: the
port compiles it itself with ``g++`` into
``<repo>/build/dgl_tpu_torch_host`` at first use (one compile a process
tree, under a file lock; the file name carries a hash of the source and
flags, so an edited source is rebuilt) and binds it with ``ctypes``. It
does not use ``csrc/Makefile``, whose target lies inside the JAX package.
Nothing here runs at import time. A failed build raises with the
compiler's output; nothing falls back to Python code.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading

import numpy as np

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
_REPO_DIR = os.path.dirname(_PKG_DIR)
SOURCE = os.path.join(_REPO_DIR, "csrc", "host_ops.cpp")
BUILD_DIR = os.path.join(_REPO_DIR, "build", "dgl_tpu_torch_host")
CXX_FLAGS = ["-O3", "-march=native", "-fPIC", "-std=c++17", "-fopenmp",
             "-shared"]

_lib = None
_lock = threading.Lock()


def _compile() -> str:
    """The library's path, compiling it unless a build of this source and
    these flags is there."""
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha1(f.read() + " ".join(CXX_FLAGS).encode())
    path = os.path.join(BUILD_DIR,
                        f"libdgl_tpu_torch_host-{digest.hexdigest()[:12]}.so")
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, "lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not os.path.exists(path):  # another process built it
                tmp = f"{path}.{os.getpid()}.tmp"
                proc = subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, SOURCE],
                                      capture_output=True, text=True)
                if proc.returncode:
                    raise RuntimeError(
                        f"building {SOURCE} with g++ failed:\n"
                        f"{proc.stderr[-4000:]}")
                os.replace(tmp, path)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return path


def library() -> ctypes.CDLL:
    """Build (once) and load the host library."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(_compile())
            i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
            u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
            lib.build_padded_block.argtypes = [
                i64p, i64p, i64p, i64p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int, ctypes.c_uint64, i64p, i64p, i64p, i64p, u8p]
            lib.build_padded_block.restype = None
            f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
            u64 = ctypes.c_uint64
            lib.sample_neighbors_fixed.argtypes = [
                i64p, i64p, i64p, i64p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int, u64, i64p, i64p, u8p]
            lib.sample_neighbors_prob.argtypes = [
                i64p, i64p, i64p, f64p, i64p, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_int, u64, i64p, i64p, u8p]
            lib.select_topk_rows.argtypes = [
                i64p, i64p, i64p, f64p, i64p, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_int, i64p, i64p, u8p]
            lib.unique_and_compact.argtypes = [i64p, ctypes.c_int64, i64p,
                                               i64p]
            lib.unique_and_compact.restype = ctypes.c_int64
            lib.random_walk_uniform.argtypes = [
                i64p, i64p, i64p, ctypes.c_int64, ctypes.c_int64, u64, i64p]
            lib.sample_neighbors_etype.argtypes = [
                i64p, i64p, i64p, i64p, ctypes.c_int64, i64p, i64p,
                ctypes.c_int64, ctypes.c_int, u64, i64p, i64p, u8p]
            i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
            f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
            lib.hem_match.argtypes = [i32p, i32p, ctypes.c_int64,
                                      ctypes.c_int64, i64p]
            lib.aggregate_csr.argtypes = [
                i32p, i32p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int, ctypes.c_int64, i64p, i32p, f32p]
            lib.aggregate_csr.restype = ctypes.c_int64
            lib.kway_gains.argtypes = [
                i64p, i32p, ctypes.c_void_p, i64p, ctypes.c_int64,
                ctypes.c_int64, i32p, f32p]
            u8w = np.ctypeslib.ndpointer(np.uint8,
                                         flags="C_CONTIGUOUS,WRITEABLE")
            lib.batched_pread.argtypes = [
                ctypes.c_int, ctypes.c_int64, i64p, ctypes.c_int64,
                ctypes.c_int64, u8w]
            lib.batched_pread.restype = ctypes.c_int64
            for name in ("sample_neighbors_fixed", "sample_neighbors_prob",
                         "select_topk_rows", "random_walk_uniform",
                         "sample_neighbors_etype", "hem_match",
                         "kway_gains"):
                getattr(lib, name).restype = None
            _lib = lib
        return _lib


def int64_arrays(rel, *fields):
    """The relation's host index arrays ``fields`` as contiguous int64,
    each converted once and kept with the relation's other host copies
    (at 10^8 edges a conversion a call would cost more than the pick)."""
    out = []
    for f in fields:
        key = ("int64", f)
        if key not in rel._host:
            rel._host[key] = np.ascontiguousarray(rel.host_arrays(f)[0],
                                                  np.int64)
        out.append(rel._host[key])
    return tuple(out)


def _i64(a):
    return np.ascontiguousarray(a, np.int64)


def _check_seeds(seeds, indptr, padding: bool = False):
    """Seed ids must be rows of the CSR (or -1, a padding slot, where
    ``padding``): the C++ reads ``indptr`` at them unchecked."""
    lo = -1 if padding else 0
    if seeds.size and (seeds.min() < lo or seeds.max() >= indptr.shape[0] - 1):
        raise ValueError(f"seed ids out of range [{lo}, "
                         f"{indptr.shape[0] - 1}): [{int(seeds.min())}, "
                         f"{int(seeds.max())}]")


def _rowwise(fn, seeds, width):
    """Call a row-wise pick that fills (num_seeds, width) neighbours, edge
    ids and a mask; returns them, the mask as bool."""
    n = seeds.shape[0]
    nbr = np.empty((n, width), np.int64)
    eid = np.empty((n, width), np.int64)
    mask = np.empty((n, width), np.uint8)
    fn(nbr.reshape(-1), eid.reshape(-1), mask.reshape(-1))
    return nbr, eid, mask.astype(bool)


def sample_neighbors_fixed(indptr, indices, eids, seeds, fanout: int,
                           replace: bool, seed: int):
    """Up to ``fanout`` uniform picks a seed row (``host_ops.cpp``'s
    ``sample_neighbors_fixed``): (num_seeds, fanout) neighbours, edge ids
    and mask. A row of degree at most ``fanout`` (without ``replace``)
    takes all its edges in order; the draws of row ``s`` are a function of
    ``(seed, s)`` alone."""
    lib = library()
    indptr, indices, eids, seeds = map(_i64, (indptr, indices, eids, seeds))
    _check_seeds(seeds, indptr)
    fanout = int(fanout)
    return _rowwise(lambda nbr, eid, mask: lib.sample_neighbors_fixed(
        indptr, indices, eids, seeds, seeds.shape[0], fanout, int(replace),
        np.uint64(seed).item(), nbr, eid, mask), seeds, fanout)


def sample_neighbors_prob(indptr, indices, eids, prob, seeds, fanout: int,
                          replace: bool, seed: int):
    """The weighted row-wise pick (``sample_neighbors_prob``): only edges
    of positive ``prob`` (indexed by edge id) are candidates."""
    lib = library()
    indptr, indices, eids, seeds = map(_i64, (indptr, indices, eids, seeds))
    prob = np.ascontiguousarray(prob, np.float64)
    _check_seeds(seeds, indptr)
    fanout = int(fanout)
    return _rowwise(lambda nbr, eid, mask: lib.sample_neighbors_prob(
        indptr, indices, eids, prob, seeds, seeds.shape[0], fanout,
        int(replace), np.uint64(seed).item(), nbr, eid, mask), seeds, fanout)


def select_topk_rows(indptr, indices, eids, weight, seeds, k: int,
                     descending: bool):
    """Each seed row's ``k`` edges of largest (``descending``) or smallest
    ``weight`` (indexed by edge id), ``select_topk_rows``."""
    lib = library()
    indptr, indices, eids, seeds = map(_i64, (indptr, indices, eids, seeds))
    weight = np.ascontiguousarray(weight, np.float64)
    _check_seeds(seeds, indptr)
    k = int(k)
    return _rowwise(lambda nbr, eid, mask: lib.select_topk_rows(
        indptr, indices, eids, weight, seeds, seeds.shape[0], k,
        int(descending), nbr, eid, mask), seeds, k)


def unique_and_compact(ids):
    """The distinct ids in order of first occurrence and each id's index
    among them (``unique_and_compact``'s hash map)."""
    lib = library()
    ids = _i64(ids)
    uniq = np.empty_like(ids)
    relabel = np.empty_like(ids)
    k = lib.unique_and_compact(ids, ids.shape[0], uniq, relabel)
    return uniq[:k], relabel


def random_walk_uniform(indptr, indices, seeds, length: int, seed: int):
    """(num_seeds, length + 1) uniform walks over a CSR, -1 after a walk
    stops at a node without out-edges (``random_walk_uniform``)."""
    lib = library()
    indptr, indices, seeds = map(_i64, (indptr, indices, seeds))
    _check_seeds(seeds, indptr)
    traces = np.empty((seeds.shape[0], int(length) + 1), np.int64)
    lib.random_walk_uniform(indptr, indices, seeds, seeds.shape[0],
                            int(length), np.uint64(seed).item(),
                            traces.reshape(-1))
    return traces


def sample_neighbors_etype(indptr, indices, eids, type_per_edge, fanouts,
                           seeds, replace: bool, seed: int):
    """Per-edge-type picks (``sample_neighbors_etype``): (num_seeds,
    sum(fanouts)) neighbours, edge ids and mask, type ``t``'s picks in
    slots ``[offs[t], offs[t] + fanouts[t])``; a seed of -1 gets none."""
    lib = library()
    indptr, indices, eids, type_per_edge, fanouts, seeds = map(
        _i64, (indptr, indices, eids, type_per_edge, fanouts, seeds))
    _check_seeds(seeds, indptr, padding=True)
    return _rowwise(lambda nbr, eid, mask: lib.sample_neighbors_etype(
        indptr, indices, eids, type_per_edge, fanouts.shape[0], fanouts,
        seeds, seeds.shape[0], int(replace), np.uint64(seed).item(), nbr,
        eid, mask), seeds, int(fanouts.sum()))


def build_padded_block(indptr, indices, eids, seed_ids, fanout: int,
                       replace: bool, seed: int):
    """One layer of the fixed-shape sampler (``csrc/host_ops.cpp``'s
    ``build_padded_block``): picks up to ``fanout`` in-neighbours of each
    seed slot (-1: a padding slot), dedups and relabels them. Returns the
    (cap_src,) source ids (-1 padding) and the (cap_dst * fanout,) edge
    sources, destinations, edge ids and mask."""
    lib = library()  # its argtypes refuse arrays not contiguous int64
    seed_ids = np.ascontiguousarray(seed_ids, np.int64)
    _check_seeds(seed_ids, indptr, padding=True)
    cap_dst = seed_ids.shape[0]
    cap_src = cap_dst * (1 + fanout)
    e_cap = cap_dst * fanout
    src_ids = np.full(cap_src, -1, np.int64)
    esrc = np.empty(e_cap, np.int64)
    edst = np.empty(e_cap, np.int64)
    eids_out = np.empty(e_cap, np.int64)
    emask = np.empty(e_cap, np.uint8)
    lib.build_padded_block(indptr, indices, eids, seed_ids, cap_dst, fanout,
                           int(replace), np.uint64(seed).item(), src_ids,
                           esrc, edst, eids_out, emask)
    return src_ids, esrc, edst, eids_out, emask.astype(bool)


def _check_ids(ids, n, what: str):
    """Ids the C++ indexes with unchecked must lie in ``[0, n)``."""
    if ids.size and (ids.min() < 0 or ids.max() >= n):
        raise ValueError(f"{what} out of range [0, {n}): "
                         f"[{int(ids.min())}, {int(ids.max())}]")


def _f32_or_null(a):
    """``a`` as contiguous float32 and its address, or (None, None): the
    C++ reads a null weight array as all ones."""
    if a is None:
        return None, None
    a = np.ascontiguousarray(a, np.float32)
    return a, a.ctypes.data_as(ctypes.c_void_p)


def hem_match(rows, cols, num_nodes: int):
    """Greedy heavy-edge matching (``hem_match``) over edges sorted by
    descending weight: (num_nodes,) int64, each node's pair
    representative (itself when unmatched)."""
    lib = library()
    rows = np.ascontiguousarray(rows, np.int32)
    cols = np.ascontiguousarray(cols, np.int32)
    if rows.shape != cols.shape:
        raise ValueError(f"rows {rows.shape} and cols {cols.shape} differ")
    _check_ids(rows, num_nodes, "hem_match rows")
    _check_ids(cols, num_nodes, "hem_match cols")
    matched = np.empty(int(num_nodes), np.int64)
    lib.hem_match(rows, cols, rows.shape[0], int(num_nodes), matched)
    return matched


def aggregate_csr(rows, cols, weights, n: int, skip_diag: bool = True,
                  row_cap: int = 0):
    """The CSR of the (row, col) pairs with their weights summed
    (``aggregate_csr``; ``weights`` None: ones), columns sorted in each
    row; ``skip_diag`` drops row == col, ``row_cap`` > 0 keeps each row's
    ``row_cap`` heaviest entries. Returns (indptr int64, cols int32,
    weights float32)."""
    lib = library()
    rows = np.ascontiguousarray(rows, np.int32)
    cols = np.ascontiguousarray(cols, np.int32)
    m = rows.shape[0]
    if cols.shape != rows.shape or (weights is not None
                                    and np.shape(weights) != rows.shape):
        raise ValueError("rows, cols and weights must be of one length")
    _check_ids(rows, n, "aggregate_csr rows")
    weights, wptr = _f32_or_null(weights)
    indptr = np.empty(int(n) + 1, np.int64)
    out_cols = np.empty(m, np.int32)
    out_w = np.empty(m, np.float32)
    nnz = lib.aggregate_csr(rows, cols, wptr, m, int(n), int(skip_diag),
                            int(row_cap), indptr, out_cols, out_w)
    return indptr, out_cols[:nnz].copy(), out_w[:nnz].copy()


def kway_gains(indptr, indices, data, parts, k: int):
    """For each row of a CSR adjacency, the best part other than its own
    by connection weight and the gain of moving there (``kway_gains``):
    (best int32, gain float32). ``k`` >= 2."""
    if k < 2:
        raise ValueError(f"kway_gains needs k >= 2, got {k}")
    lib = library()
    indptr = np.ascontiguousarray(indptr, np.int64)
    indices = np.ascontiguousarray(indices, np.int32)
    parts = np.ascontiguousarray(parts, np.int64)
    data, dptr = _f32_or_null(data)
    n = indptr.shape[0] - 1
    if parts.shape != (n,) or indptr[-1] > indices.shape[0] or (
            data is not None and data.shape != indices.shape):
        raise ValueError("kway_gains: indptr, indices, data and parts do "
                         "not describe one CSR of its rows")
    _check_ids(indices, n, "kway_gains indices")
    _check_ids(parts, k, "kway_gains parts")
    best = np.empty(n, np.int32)
    gain = np.empty(n, np.float32)
    lib.kway_gains(indptr, indices, dptr, parts, n, int(k), best, gain)
    return best, gain


def batched_pread(fd: int, offset0: int, ids, row_bytes: int, out):
    """Read rows ``ids`` of the fixed-width records that start at byte
    ``offset0`` of the open file ``fd`` into ``out`` (a writeable,
    contiguous uint8 array of at least ``len(ids) * row_bytes`` bytes) with
    parallel ``pread`` calls (``batched_pread``): row ``i`` of the output is
    the file's bytes ``[offset0 + ids[i] * row_bytes, + row_bytes)``. The
    file is never mapped. Returns the number of rows read in full. Ids
    must be rows of the file, as its size gives them."""
    lib = library()
    ids = _i64(ids).reshape(-1)
    row_bytes, offset0 = int(row_bytes), int(offset0)
    if row_bytes <= 0 or offset0 < 0:
        raise ValueError(f"batched_pread: row_bytes {row_bytes} and "
                         f"offset0 {offset0} must be > 0 and >= 0")
    if not (isinstance(out, np.ndarray) and out.dtype == np.uint8
            and out.flags.c_contiguous and out.flags.writeable):
        raise ValueError("batched_pread: out must be a writeable, "
                         "contiguous uint8 array")
    out = out.reshape(-1)
    if out.shape[0] < ids.shape[0] * row_bytes:
        raise ValueError(f"batched_pread: out holds {out.shape[0]} bytes, "
                         f"{ids.shape[0]} rows need "
                         f"{ids.shape[0] * row_bytes}")
    rows = (os.fstat(fd).st_size - offset0) // row_bytes
    _check_ids(ids, rows, "batched_pread ids")
    return int(lib.batched_pread(int(fd), offset0, ids, ids.shape[0],
                                 row_bytes, out))
