"""The traced segment of a ``--trace 1`` run, and what the per-layer
readers take from it.

The harness's own calls are wrapped in host ranges (``record_function``:
``forward``, ``loss``, ``backward``, ``optimizer``, ``sync``) with a pair
of CUDA events each. ``torch.profiler`` traces a warm call and then the
segment; only device operations that start inside the segment's range
count (the trace can lose the first launches after it starts), as
``chip_smoke.py::device_profile`` counts them.
"""
from __future__ import annotations

import contextlib

import torch

WINDOW = "portbench_window"
SPAN_NAMES = ("forward", "loss", "backward", "optimizer", "sync")


def no_spans(_name):
    return contextlib.nullcontext()


class Spans:
    """Host ranges with CUDA events around the harness's calls."""

    def __init__(self):
        self.records = []

    @contextlib.contextmanager
    def __call__(self, name: str):
        from torch.profiler import record_function

        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with record_function(name):
            start.record()
            yield
            end.record()
        self.records.append((name, start, end))

    def ms_per_step(self, steps: int) -> dict:
        """Each range's device time a step (call after a synchronise)."""
        out: dict = {}
        for name, start, end in self.records:
            out[name] = out.get(name, 0.0) + start.elapsed_time(end)
        return {k: v / steps for k, v in out.items()}


def _union(intervals) -> list:
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def profile_segment(step, steps: int) -> dict:
    """Trace ``steps`` calls of ``step(spans)`` (which runs one step or
    forward, inside the ranges it names) and a final synchronise; return
    the segment's summary: its wall and busy seconds, device operations a
    step, seconds and launches by operation name, idle seconds by the host
    range active in the middle of each gap, and each range's device
    milliseconds a step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    step(no_spans)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(no_spans)
        torch.cuda.synchronize()
        spans = Spans()
        with record_function(WINDOW):
            for _ in range(steps):
                step(spans)
            with spans("sync"):
                torch.cuda.synchronize()
    events = prof.events()
    host = [ev for ev in events if ev.device_type == DeviceType.CPU]
    host_names = {ev.name for ev in host}
    win = next(ev for ev in host if ev.name == WINDOW)
    ws, we = win.time_range.start, win.time_range.end
    dev = [ev for ev in events if ev.device_type == DeviceType.CUDA
           and ev.name not in host_names and ws <= ev.time_range.start <= we]
    ops: dict = {}
    for ev in dev:
        key = ev.name[:80]  # operations whose names share it are summed
        s, n = ops.get(key, (0.0, 0))
        ops[key] = (s + ev.time_range.elapsed_us() / 1e6, n + 1)
    busy = _union([(max(ev.time_range.start, ws), min(ev.time_range.end, we))
                   for ev in dev])
    ranges = [(ev.time_range.start, ev.time_range.end, ev.name)
              for ev in host if ev.name in SPAN_NAMES
              and ws <= ev.time_range.start <= we]
    idle: dict = {}
    edges = [ws] + [t for b in busy for t in b] + [we]
    for gs, ge in zip(edges[::2], edges[1::2]):
        if ge <= gs:
            continue
        mid = (gs + ge) / 2
        label = next((n for s, e, n in ranges if s <= mid <= e), "other")
        idle[label] = idle.get(label, 0.0) + (ge - gs) / 1e6
    return {"steps": steps, "window_s": (we - ws) / 1e6,
            "busy_s": sum(e - s for s, e in busy) / 1e6,
            "launches": len(dev) / steps,
            "ops": ops, "idle": idle,
            "spans_ms": spans.ms_per_step(steps)}


def breakdown(summary: dict) -> dict:
    top = sorted(summary["ops"].items(), key=lambda kv: -kv[1][0])[:10]
    idle = sorted(summary["idle"].items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k, v[0]] for k, v in top],
            "idle_gaps": [[k, v] for k, v in idle]}
