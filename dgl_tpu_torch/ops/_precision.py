"""Full-f32 matmuls whatever the process's TF32 setting.

``torch.backends.cuda.matmul.allow_tf32 = True`` or
``torch.set_float32_matmul_precision("high")``, set anywhere in a process,
lets cuBLAS run an f32 product on the tensor cores with 10-bit mantissas.
The exact plan modes promise f32 sums (the reference pins
``Precision.HIGHEST``), so their products run inside :func:`full_f32`.
"""
from __future__ import annotations

import contextlib

import torch

__all__ = ["full_f32"]


@contextlib.contextmanager
def full_f32():
    """Within the block, f32 matmuls run in full f32 (precision
    ``"highest"``); the setting before it is restored after it.

    PyTorch keeps the setting twice: one process-wide value
    (``set_float32_matmul_precision``, ``allow_tf32``) and, since 2.9, one
    a backend (``torch.backends.cuda.matmul.fp32_precision`` and
    ``torch.backends.mkldnn.matmul.fp32_precision``), and a matmul refuses
    to run while the two disagree. ``set_float32_matmul_precision`` sets
    both; the backends' own values are put back one by one after it."""
    if not hasattr(torch.backends.cuda.matmul, "fp32_precision"):
        before = torch.get_float32_matmul_precision()
        torch.set_float32_matmul_precision("highest")
        try:
            yield
        finally:
            torch.set_float32_matmul_precision(before)
        return
    backends = [b for b in (torch.backends.cuda.matmul,
                            getattr(torch.backends.mkldnn, "matmul", None))
                if hasattr(b, "fp32_precision")]
    saved = [(b, b.fp32_precision) for b in backends]
    try:
        before = torch.get_float32_matmul_precision()
    except RuntimeError:  # the two were set apart: read it off the CUDA one
        tf32 = torch.backends.cuda.matmul.fp32_precision == "tf32"
        try:
            torch.backends.cuda.matmul.allow_tf32  # raises unless they agree
        except RuntimeError:
            tf32 = not tf32
        before = "high" if tf32 else "highest"
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(before)
        for backend, value in saved:
            if backend.fp32_precision != value:
                backend.fp32_precision = value
