"""The least time of the work that a kernel does, from the work itself and
not from any kernel's layout, so that a redesigned kernel is held to the
same work.

B1, the hub plan's cold-tail sum (``out[d] = base[d] + sum over d's cold
edges within the shell levels of x[s]``), at feature width ``F``: bytes are
one 4-byte source index an edge, each distinct source row once at the
plan's gather width, each output row written once in f32 and, where the
direction has a residual, the residual base read once in f32; operations
are one f32 add an edge and feature. The least time is the larger of bytes
over the card's HBM rate and operations over its f32 rate.
"""
from __future__ import annotations


def b1_least_seconds(tail: dict, width: int, peaks) -> float:
    out_bytes = tail["n_out"] * width * 4 * (2 if tail["base"] else 1)
    nbytes = (4 * tail["edges"] + tail["rows"] * width * tail["elem"]
              + out_bytes)
    ops = tail["edges"] * width
    return max(nbytes / peaks.hbm_bytes_per_s, ops / peaks.f32_flops_per_s)


def b1_least_per_step(aggs, tails: dict, peaks) -> float:
    """The sum over one step's aggregations ``(relation, width,
    direction)`` whose direction runs B1 (``tails[relation][direction]``
    not None)."""
    total = 0.0
    for rel, width, direction in aggs:
        tail = tails[rel][direction]
        if tail is not None:
            total += b1_least_seconds(tail, width, peaks)
    return total
