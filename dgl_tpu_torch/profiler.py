"""Profiling utilities (counterpart of ``dgl_tpu/profiler.py``): timers of
the input pipeline's stages, and a device trace through ``torch.profiler``
(the reference wraps ``jax.profiler``)."""
from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict

__all__ = ["StageTimer", "profile_trace", "timed_stage"]


class StageTimer:
    """Accumulates wall time per named pipeline stage.

    >>> timer = StageTimer()
    >>> with timer.stage("sample"): ...
    >>> timer.summary()
    """

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            k: {
                "total_s": round(self.totals[k], 4),
                "count": self.counts[k],
                "mean_ms": round(1e3 * self.totals[k] / max(self.counts[k], 1), 3),
            }
            for k in self.totals
        }

    def reset(self):
        self.totals.clear()
        self.counts.clear()

    def __repr__(self):
        return f"StageTimer({self.summary()})"


@contextlib.contextmanager
def profile_trace(logdir: str):
    """Trace the block's host and CUDA activity with ``torch.profiler`` and
    write it as a Chrome trace, ``logdir/trace_<pid>_<ns>.json`` (open it
    in Perfetto or ``chrome://tracing``)."""
    import torch

    from torch.profiler import ProfilerActivity

    os.makedirs(logdir, exist_ok=True)
    prof = torch.profiler.profile(
        activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    with prof:
        yield
    prof.export_chrome_trace(os.path.join(
        logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def timed_stage(timer: StageTimer, name: str, it):
    """Wrap an iterator so each ``next`` is timed as ``name``."""
    it = iter(it)
    while True:
        with timer.stage(name):
            try:
                item = next(it)
            except StopIteration:
                return
        yield item
