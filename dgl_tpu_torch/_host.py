"""Build, load and call the host sampler library (``csrc/host_ops.cpp``).

``csrc/host_ops.cpp`` is framework-free C++ shared by both packages: the
port compiles it itself with ``g++`` into
``<repo>/build/dgl_tpu_torch_host`` at first use (one compile a process
tree, under a file lock; the file name carries a hash of the source and
flags, so an edited source is rebuilt) and binds it with ``ctypes``. It
does not use ``csrc/Makefile``, whose target lies inside the JAX package.
Nothing here runs at import time. A failed build raises with the
compiler's output; nothing falls back to a Python sampler.
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
            _lib = lib
        return _lib


def csc_int64(rel):
    """The relation's host CSC (``indptr``, ``indices``, ``eids``) as
    contiguous int64, converted once and kept with the relation's other
    host copies."""
    key = "_csc_int64"
    if key not in rel._host:
        rel._host[key] = tuple(
            np.ascontiguousarray(a, np.int64) for a in rel.host_arrays(
                "csc_indptr", "csc_indices", "csc_eids"))
    return rel._host[key]


def build_padded_block(indptr, indices, eids, seed_ids, fanout: int,
                       replace: bool, seed: int):
    """One layer of the fixed-shape sampler (``csrc/host_ops.cpp``'s
    ``build_padded_block``): picks up to ``fanout`` in-neighbours of each
    seed slot (-1: a padding slot), dedups and relabels them. Returns the
    (cap_src,) source ids (-1 padding) and the (cap_dst * fanout,) edge
    sources, destinations, edge ids and mask."""
    lib = library()  # its argtypes refuse arrays not contiguous int64
    seed_ids = np.ascontiguousarray(seed_ids, np.int64)
    if seed_ids.size and seed_ids.max() >= indptr.shape[0] - 1:
        raise ValueError(f"seed id {int(seed_ids.max())} out of range "
                         f"[0, {indptr.shape[0] - 1})")
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
