"""PNA/DGN aggregator and scaler functions (counterpart of
``dgl_tpu/nn/conv/pna_helpers.py``; reference
``python/dgl/nn/pytorch/conv/pnaconv.py:8-100`` and ``dgnconv.py:11-60``).

They work on the dense (num_dst, deg, D) stacked-message tensor of the
reference's degree-bucketed reduce, the layout of a padded mailbox (mask
the padding rows before calling, or use :class:`PNAConv`, which reduces
with g-SpMM). The port keeps its own copy: it imports nothing of the JAX
package.
"""
from __future__ import annotations

import torch

__all__ = [
    "aggregate_mean",
    "aggregate_max",
    "aggregate_min",
    "aggregate_sum",
    "aggregate_var",
    "aggregate_std",
    "aggregate_moment_3",
    "aggregate_moment_4",
    "aggregate_moment_5",
    "aggregate_dir_av",
    "aggregate_dir_dx",
    "scale_identity",
    "scale_amplification",
    "scale_attenuation",
    "get_aggregate_fn",
]


def aggregate_mean(h):
    """(reference ``pnaconv.py:8``)."""
    return h.mean(1)


def aggregate_max(h):
    return h.max(1).values


def aggregate_min(h):
    return h.min(1).values


def aggregate_sum(h):
    return h.sum(1)


def aggregate_var(h):
    """(reference ``pnaconv.py:33``)."""
    h_mean_squares = (h * h).mean(1)
    h_mean = h.mean(1)
    diff = h_mean_squares - h_mean * h_mean
    return torch.maximum(diff, torch.zeros_like(diff))


def aggregate_std(h):
    return torch.sqrt(aggregate_var(h) + 1e-30)


def _aggregate_moment(h, n):
    h_mean = h.mean(1, keepdim=True)
    h_n = ((h - h_mean) ** n).mean(1)
    return torch.sign(h_n) * torch.abs(h_n + 1e-30) ** (1.0 / n)


def aggregate_moment_3(h):
    return _aggregate_moment(h, 3)


def aggregate_moment_4(h):
    return _aggregate_moment(h, 4)


def aggregate_moment_5(h):
    return _aggregate_moment(h, 5)


def aggregate_dir_av(h, eig_s, eig_d, eig_idx):
    """Directional average over an eigenvector field (reference
    ``dgnconv.py:11``)."""
    w = torch.abs(eig_s[:, :, eig_idx] - eig_d[:, :, eig_idx])
    w = w / (w.sum(1, keepdim=True) + 1e-30)
    return (h * w.unsqueeze(-1)).sum(1)


def aggregate_dir_dx(h, eig_s, eig_d, h_in, eig_idx):
    """Directional derivative (reference ``dgnconv.py:34``)."""
    w = eig_s[:, :, eig_idx] - eig_d[:, :, eig_idx]
    w = w / (torch.abs(w).sum(1, keepdim=True) + 1e-30)
    return torch.abs((h * w.unsqueeze(-1)).sum(1) - h_in)


def scale_identity(h, D=None, delta=None):
    """(reference ``pnaconv.py:64``)."""
    return h


def scale_amplification(h, D, delta):
    """(reference ``pnaconv.py:69``)."""
    return h * (torch.log(D + 1) / delta).unsqueeze(-1)


def scale_attenuation(h, D, delta):
    """(reference ``pnaconv.py:74``)."""
    return h * (delta / torch.log(D + 1)).unsqueeze(-1)


AGGREGATORS = {
    "mean": aggregate_mean,
    "max": aggregate_max,
    "min": aggregate_min,
    "sum": aggregate_sum,
    "var": aggregate_var,
    "std": aggregate_std,
    "moment3": aggregate_moment_3,
    "moment4": aggregate_moment_4,
    "moment5": aggregate_moment_5,
}


def get_aggregate_fn(aggregator: str):
    """Name -> dense aggregator; ``dir-<k>``/``dir_av-<k>`` and
    ``dir_dx-<k>`` give the directional pair over eigenvector column
    ``k``, taking ``(h, eig_s, eig_d)`` and ``(h, eig_s, eig_d, h_in)``."""
    if aggregator in AGGREGATORS:
        return AGGREGATORS[aggregator]
    if aggregator.startswith("dir") and "-" in aggregator:
        kind, idx = aggregator.split("-")
        eig_idx = int(idx)
        if kind in ("dir_av", "dir"):
            def f(h, eig_s, eig_d):
                return aggregate_dir_av(h, eig_s, eig_d, eig_idx)
            return f
        if kind == "dir_dx":
            def f(h, eig_s, eig_d, h_in):
                return aggregate_dir_dx(h, eig_s, eig_d, h_in, eig_idx)
            return f
    raise ValueError(f"unknown aggregator {aggregator!r}")
