"""Build, load and count the port's hand-written CUDA kernels.

The kernels live as CUDA C++ under ``dgl_tpu_torch/csrc/`` with a plain C
interface. They are compiled for Hopper (``sm_90a``) at first use with
``torch.utils.cpp_extension.load`` into ``<repo>/build/dgl_tpu_torch_kernels``
(ninja compiles the sources in parallel, one ``nvcc`` each) and bound with
``ctypes``; no source includes PyTorch's headers, so the build takes
seconds. Nothing here runs at import time: the CPU tests import
every module on a machine without ``nvcc``.

Every wrapper that launches a kernel adds one to its entry in
:data:`launch_counts`, so a run can show that its path went through the
kernel. The f32 instantiations of the shell prefix sum and the bitmap SpMM
(the exact plan modes) count under names of their own,
``shell_prefix_sum_f32`` and ``bitmap_spmm_f32``. A failed build or launch raises; nothing falls back.
"""
from __future__ import annotations

import ctypes
import os
import threading

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
_REPO_DIR = os.path.dirname(_PKG_DIR)
BUILD_DIR = os.path.join(_REPO_DIR, "build", "dgl_tpu_torch_kernels")
SOURCES = tuple(os.path.join(_PKG_DIR, "csrc", name) for name in (
    "shell_prefix_sum.cu", "bitmap_spmm.cu", "bitmap_gat_fwd.cu",
    "bitmap_gat_bwd_dst.cu", "bitmap_gat_bwd_src.cu", "hub_gather.cu"))
CUDA_FLAGS = ["-O3", "-gencode=arch=compute_90a,code=sm_90a"]

launch_counts = {"shell_prefix_sum": 0, "shell_prefix_sum_f32": 0,
                 "shell_prefix_gspmm": 0, "bitmap_spmm": 0,
                 "bitmap_spmm_f32": 0,
                 "bitmap_gat_fwd": 0, "bitmap_gat_bwd_dst": 0,
                 "bitmap_gat_bwd_src": 0, "hub_gather": 0}

_P, _I64, _I32, _F32 = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                        ctypes.c_float)
# each C function's parameters (``extern "C"`` in csrc/*.cu; every one
# returns a cudaError_t as int); tests/test_torch_kernels_abi.py holds this
# table to the sources
ARGTYPES = {
    "dgl_shell_prefix_sum":
        [_P, _I32, _I64, _I64, _P, _P, _P, _I32, _P, _P, _I64, _I32, _P],
    "dgl_shell_prefix_gspmm":
        [_I32, _I32, _P, _I32, _I64, _I64, _P, _I32, _I64, _I64, _P, _P, _P,
         _P, _I32, _P, _P, _P, _I64, _I64, _I32, _P],
    "dgl_shell_prefix_gspmm_occupancy":
        [_I32, _I32, _I32, _I32, _I32, _I64, _I32, _P],
    "dgl_bitmap_spmm": [_P, _P, _I64, _P, _I32, _I64, _I64, _I64, _I32, _P,
                        _P],
    "dgl_bitmap_gat_fwd":
        [_P, _P, _I64, _P, _P, _P, _I64, _I32, _I32, _I32, _I32, _I32, _I32,
         _F32, _P, _P, _P],
    "dgl_bitmap_gat_bwd_dst":
        [_P, _P, _I64, _P, _P, _P, _P, _P, _P, _I64, _I32, _I32, _I32, _I32,
         _I32, _F32, _P, _P],
    "dgl_bitmap_gat_bwd_src":
        [_P, _P, _I64, _P, _P, _P, _P, _I64, _I32, _I32, _I32, _I32, _I32,
         _I32, _F32, _P, _P, _P],
    "dgl_bitmap_gat_fwd_occupancy": [_I32, _I32, _P],
    "dgl_bitmap_gat_bwd_dst_occupancy": [_I32, _I32, _P],
    "dgl_bitmap_gat_bwd_src_occupancy": [_I32, _I32, _P],
    "dgl_hub_gather": [_P, _I64, _I64, _I32, _P, _I64, _I32, _P, _I32, _P],
}

_lib = None
_lock = threading.Lock()


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def library() -> ctypes.CDLL:
    """Build (once per process) and load the kernel library."""
    global _lib
    with _lock:
        if _lib is None:
            from torch.utils.cpp_extension import load

            os.makedirs(BUILD_DIR, exist_ok=True)
            path = load(
                name="dgl_tpu_torch_kernels",
                sources=list(SOURCES),
                build_directory=BUILD_DIR,
                extra_cuda_cflags=CUDA_FLAGS,
                is_python_module=False,
            )
            lib = ctypes.CDLL(path)
            for name, argtypes in ARGTYPES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def check(code: int, name: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launch."""
    if code != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError_t {code}")
