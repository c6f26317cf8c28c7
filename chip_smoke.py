#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (``dgl_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Run it from the root of a checkout, on a machine with a CUDA card. It

1. builds the hand-written CUDA kernel from ``dgl_tpu_torch/csrc``;
2. drives the main path once: the ogbn-arxiv-scale zipf graph
   (169,343 nodes, 1,166,243 edges, as ``bench.py`` builds it),
   ``reorder_for_spmm(num_hubs=2048, precision="int8")`` and a 3-layer
   GraphSAGE 128 -> 256 -> 256 -> 40 (mean aggregator, eval mode, weights
   drawn from seed 0) under ``torch.inference_mode()``, with the kernels'
   launch counts set to 0 just before and read just after;
3. runs two more forward passes and holds the output against the same
   model on the plain exact-f32 path (a graph without a plan) at
   rtol = 2e-2, atol = 2e-2 * max|ref| (the hub path rounds the aggregated
   rows to bf16);
4. holds the kernel against its plain PyTorch version on the card, on the
   three layers' real shell inputs (F = 128, 256, 40) and at the bench
   headline width (F = 256), at rtol = atol = 1e-5 (both sum the same f32
   values in the same order);
5. times the kernel, its plain version and
   ``torch.nn.functional.embedding_bag(mode="sum")`` over the same cold
   edges (device time, launches back to back), computes the kernel's bound
   from the bytes it must move, then times the forward pass on both paths
   and ``copy_u_sum`` at F = 256 as a caller waits for them, and breaks the
   forward's device time down by kernel with ``torch.profiler``.

It prints one JSON object per result line, the kernel table as
``{"kernels": [...]}``, the card's name and power limit, and as its last
line ``{"ok": true, "device": {...}}``. Any failure exits non-zero before
that line. Without a CUDA card, or outside a checkout, it exits non-zero
and prints no result.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

N_NODES, N_EDGES = 169_343, 1_166_243  # bench.py:178-183
IN_FEATS, HIDDEN, CLASSES, LAYERS = 128, 256, 40, 3  # OGB arxiv GraphSAGE
HEADLINE_F = 256
# HBM bandwidth by card name (NVIDIA data sheets), bytes/s
HBM_RATE = (("H100 NVL", 3.9e12), ("H100 PCIe", 2.0e12), ("H200", 4.8e12),
            ("H100", 3.35e12))
F32_RATE = 67e12  # H100 SXM f32 outside the tensor cores, FLOP/s


def _fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_info() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0].strip()


def hbm_rate(name: str) -> float:
    for key, rate in HBM_RATE:
        if key in name:
            return rate
    raise RuntimeError(f"no HBM bandwidth on record for {name!r}")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def time_ms(fn, iters: int, warmup: int = 2, hide_host: bool = False) -> float:
    """Mean time of ``fn()`` in ms, by CUDA events around ``iters``
    back-to-back calls after ``warmup`` calls.

    With ``hide_host`` the stream first runs a spin kernel that lasts
    longer than the host needs to enqueue the ``iters`` calls, so the
    events time the device's work with no gaps left by Python between
    launches (a kernel's own time). Without it they time what a caller
    waits for, host overhead included (a forward pass)."""
    import torch

    host_s = 0.0
    for _ in range(warmup):
        t = time.perf_counter()
        fn()
        host_s = max(host_s, time.perf_counter() - t)
        torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if hide_host:  # cycles at up to 2 GHz, twice the enqueue time
        torch.cuda._sleep(min(int(host_s * iters * 2 * 2e9) + 1_000_000,
                              4_000_000_000))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_profile(fn, iters: int) -> dict:
    """Device time by kernel name over ``iters`` calls of ``fn`` under
    ``torch.profiler``, and the device's busy share of the wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name: dict = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            us = ev.time_range.elapsed_us()
            by_name[ev.name] = by_name.get(ev.name, 0.0) + us
    busy_us = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {
        "wall_ms_per_call": wall_us / iters / 1e3,
        "device_busy_ms_per_call": busy_us / iters / 1e3,
        "device_idle_share": (1 - busy_us / wall_us) if busy_us else None,
        "kernels_ms_per_call": {k[:80]: v / iters / 1e3 for k, v in top},
    }


def zipf_graph(seed: int = 0):
    """bench.py's arxiv-scale graph: zipf(s=1) sources, uniform dsts."""
    import numpy as np

    rng = np.random.default_rng(seed)
    w = 1.0 / np.arange(1, N_NODES + 1)
    src = rng.choice(N_NODES, N_EDGES, p=w / w.sum())
    dst = rng.integers(0, N_NODES, N_EDGES)
    return src, dst


def cold_bags(plan, n_table):
    """The plan's cold edges as embedding_bag input: per output row, the
    table rows its shell levels gather (out-of-range slots dropped)."""
    import torch

    from dgl_tpu_torch.ops.shell_prefix import BLOCK_ROWS, _rup

    rows, cols, off = [], [], 0
    for m in plan.shell_rows:
        mm = min(m, plan.num_dst)
        idx = plan.shell_idx[off:off + mm].long()
        r = torch.arange(mm, device=idx.device)
        keep = idx < n_table
        rows.append(r[keep])
        cols.append(idx[keep])
        off += _rup(m, BLOCK_ROWS)
    rows, cols = torch.cat(rows), torch.cat(cols)
    order = torch.sort(rows, stable=True).indices
    counts = torch.bincount(rows, minlength=plan.num_dst)
    offsets = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])
    return cols[order], offsets


def kernel_bound(plan, n_table_rows_used, n_cold, feat, has_base, rate):
    """Least time for one call: the larger of bytes / HBM rate and f32
    adds / f32 rate. Bytes: each distinct table row read once (bf16),
    every index read once (int32), the base read once and the output
    written once (f32). Also returns the gather-stream figure, which reads
    a table row per cold edge."""
    n_out = plan.num_dst
    n_idx = sum(min(m, n_out) for m in plan.shell_rows)
    out_bytes = n_out * feat * 4 * (2 if has_base else 1)
    once = n_table_rows_used * feat * 2 + n_idx * 4 + out_bytes
    stream = n_cold * feat * 2 + n_cold * 4 + out_bytes
    bytes_ms = once / rate * 1e3
    ops_ms = n_cold * feat / F32_RATE * 1e3
    bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
    return max(bytes_ms, ops_ms), bound_by, stream / rate * 1e3


def run() -> dict:
    import numpy as np
    import torch

    import dgl_tpu_torch as dt
    from dgl_tpu_torch import _kernels
    from dgl_tpu_torch.models import GraphSAGE
    from dgl_tpu_torch.ops import hub_spmm
    from dgl_tpu_torch.ops.shell_prefix import (shell_prefix_sum,
                                                shell_prefix_sum_plain)

    card = card_info()
    name = torch.cuda.get_device_name(0)
    rate = hbm_rate(name)
    tag = {"card": card}

    # 1. build the kernel from the checkout's sources
    t0 = time.perf_counter()
    _kernels.library()
    emit({"phase": "build", "kernel": "shell_prefix_sum",
          "seconds": time.perf_counter() - t0, **tag})

    # 2. the main path, driven once with the launch counts read around it
    t0 = time.perf_counter()
    src, dst = zipf_graph(0)
    g = dt.graph((src, dst), num_nodes=N_NODES)
    gp, perm = dt.transforms.reorder_for_spmm(g, num_hubs=2048,
                                              precision="int8")
    plan = gp._relation().hub_plan
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(N_NODES, IN_FEATS)).astype(np.float32)).cuda()
    model = GraphSAGE(IN_FEATS, HIDDEN, CLASSES, num_layers=LAYERS,
                      aggregator_type="mean",
                      generator=torch.Generator().manual_seed(0)).eval()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launch_counts()
    with torch.inference_mode():
        out = model(gp, x)
    torch.cuda.synchronize()
    launches = dict(_kernels.launch_counts)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    if launches["shell_prefix_sum"] != LAYERS:
        raise RuntimeError(f"main path launched the kernel "
                           f"{launches['shell_prefix_sum']} times, "
                           f"expected {LAYERS} (one per layer)")
    emit({"phase": "main_path", "graph": {"nodes": N_NODES,
                                          "edges": N_EDGES},
          "hub_plan": repr(plan), "shell_levels": len(plan.shell_rows),
          "residual": plan.res_dst is not None, "setup_s": setup_s,
          "launches": launches, "peak_memory_gib": peak_gib, **tag})

    # 3. two more passes, then the exact f32 path on the same graph
    with torch.inference_mode():
        outs = [out] + [model(gp, x) for _ in range(2)]
        rel = gp._relation()
        g_ref = dt.graph((rel.src.cpu(), rel.dst.cpu()), num_nodes=N_NODES)
        ref = model(g_ref, x)
    torch.cuda.synchronize()
    for o in outs:
        if tuple(o.shape) != (N_NODES, CLASSES) or not torch.isfinite(o).all():
            raise RuntimeError(f"bad output {tuple(o.shape)}")
    repeat_err = max((o - outs[0]).abs().max().item() for o in outs[1:])
    scale = ref.abs().max().item()
    err = (outs[0] - ref).abs().max().item()
    if not torch.allclose(outs[0], ref, rtol=2e-2, atol=2e-2 * scale):
        raise RuntimeError(f"hub path vs exact f32 path: max abs err {err} "
                           f"(max |ref| {scale})")
    emit({"phase": "slice_vs_exact_f32", "max_abs_err": err,
          "max_rel_err": err / scale, "repeat_max_abs_err": repeat_err,
          "tolerance": "rtol=2e-2, atol=2e-2*max|ref|", **tag})

    # 4. kernel vs plain on the card: the three layers' real shell inputs
    # and the bench headline width
    with torch.inference_mode():
        h1 = torch.relu(model.sage0(gp, x))
        h2 = torch.relu(model.sage1(gp, h1))
        tables = {
            "layer0 F=128": x,
            "layer1 F=256": h1,
            "layer2 F=40": model.sage2.fc_neigh(h2),
            "headline F=256": torch.from_numpy(np.random.default_rng(2).normal(
                size=(N_NODES, HEADLINE_F)).astype(np.float32)).cuda(),
        }
    bag_idx, bag_off = cold_bags(plan, N_NODES)
    n_cold = int(bag_idx.shape[0])
    rows_used = int(torch.unique(bag_idx).shape[0])
    shell_args = (plan.shell_idx, plan.shell_rows, N_NODES)
    per_shape = {}
    with torch.inference_mode():
        for label, t in tables.items():
            xg = t.to(torch.bfloat16).contiguous()
            base = hub_spmm._residual_base(xg, plan)
            kw = {"base": base, "levels": plan.shell_levels}
            got = shell_prefix_sum(xg, *shell_args, **kw)
            want = shell_prefix_sum_plain(xg, *shell_args, base=base)
            torch.cuda.synchronize()
            abs_err = (got - want).abs().max().item()
            rel_err = abs_err / max(want.abs().max().item(), 1e-30)
            if not torch.allclose(got, want, rtol=1e-5, atol=1e-5):
                raise RuntimeError(f"kernel vs plain at {label}: max abs "
                                   f"err {abs_err}")
            feat = xg.shape[1]
            lib = lambda: torch.nn.functional.embedding_bag(  # noqa: E731
                bag_idx, xg, bag_off, mode="sum", include_last_offset=True)
            lib_err = (lib().float() - want).abs().max().item()
            bound, bound_by, stream_ms = kernel_bound(
                plan, rows_used, n_cold, feat, base is not None, rate)
            kern = lambda: shell_prefix_sum(xg, *shell_args, **kw)  # noqa: E731
            per_shape[label] = {
                "F": feat, "max_abs_err": abs_err, "max_rel_err": rel_err,
                "ms": time_ms(kern, 50, hide_host=True),
                "ms_with_host": time_ms(kern, 50),
                "plain_ms": time_ms(lambda: shell_prefix_sum_plain(
                    xg, *shell_args, base=base), 10, hide_host=True),
                "library_ms": time_ms(lib, 50, hide_host=True),
                "library_max_abs_err_bf16_out": lib_err,
                "bound_ms": bound, "bound_by": bound_by,
                "gather_stream_bound_ms": stream_ms,
            }
            emit({"phase": "kernel_vs_plain", "kernel": "shell_prefix_sum",
                  "shape": label, "n_out": N_NODES, "cold_edges": n_cold,
                  "table_rows_read": rows_used, **per_shape[label], **tag})

    # 5. end-to-end times, host overhead included, and where the forward's
    # device time goes
    with torch.inference_mode():
        fwd_ms = time_ms(lambda: model(gp, x), 10)
        xh = tables["headline F=256"]
        spmm_ms = time_ms(lambda: dt.ops.copy_u_sum(gp, xh), 20)
        exact_fwd_ms = time_ms(lambda: model(g_ref, x), 5)
        prof = device_profile(lambda: model(gp, x), 3)
    gbps = (N_EDGES + N_NODES) * HEADLINE_F * 4 / (spmm_ms * 1e-3) / 1e9
    emit({"phase": "timing", "forward_ms": fwd_ms,
          "exact_f32_path_forward_ms": exact_fwd_ms,
          "copy_u_sum_f256_ms": spmm_ms, "copy_u_sum_f256_effective_gbps":
          gbps, "gbps_bytes": "(E+N)*F*4", "hbm_rate_gbps": rate / 1e9,
          **tag})
    emit({"phase": "forward_profile", "calls": 3, **prof, **tag})

    main = per_shape["layer1 F=256"]
    return {
        "kernels": [{
            "name": "shell_prefix_sum",
            "route": "cuda",
            "source": "dgl_tpu_torch/csrc/shell_prefix_sum.cu",
            "replaces": "dgl_tpu/ops/shell_pallas.py:110",
            "launches": launches["shell_prefix_sum"],
            "max_abs_err": max(v["max_abs_err"] for v in per_shape.values()),
            "ms": main["ms"],
            "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"],
            "library_ms": main["library_ms"],
            "shape": f"layer1 F=256, n_out={N_NODES}, times per call",
        }],
        "card": card,
    }


def main() -> int:
    if not os.path.isdir(os.path.join(ROOT, "dgl_tpu_torch")):
        _fail("dgl_tpu_torch/ is not beside chip_smoke.py: run it from the "
              "root of a checkout")
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is false: this script needs a "
              "CUDA card")
    try:
        result = run()
    except Exception as exc:  # any failed phase fails the run
        import traceback

        traceback.print_exc()
        _fail(f"{type(exc).__name__}: {exc}")
    emit({"kernels": result["kernels"]})
    print(f"card: {result['card']}", flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
