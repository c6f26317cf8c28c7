#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (``dgl_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Run it from the root of a checkout, on a machine with a CUDA card. It

1. builds the hand-written CUDA kernels from ``dgl_tpu_torch/csrc`` (one
   ``nvcc`` per source, started together);

the GraphSAGE path (kernel B1, shell prefix sum):

2. drives it once: the ogbn-arxiv-scale zipf graph (169,343 nodes,
   1,166,243 edges, as ``bench.py`` builds it),
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
   forward's device time down by kernel with ``torch.profiler``;

the Reddit-scale GCN and GAT paths (kernels B2, bitmap SpMM, and B3,
bitmap-flash GAT forward):

6. builds the synthetic Reddit stand-in at full scale (232,965 nodes, the
   SBM recipe of ``dgl_tpu/data/synthetic.py``, 602-wide features) and
   ``with_spmm_plans(num_hubs=256, bitmap=True, bitmap_max_bytes=8 << 30)``;
7. drives GCN 602 -> 16 -> 41 once (eval, weights from seed 0, counts read
   around it: two B2 launches) and holds it against the exact-f32 path at
   rtol = 2e-2, atol = 2e-2 * max|ref| (the bitmap path rounds the
   aggregated rows to bf16);
8. drives GAT 602 -> 8 x 8 heads -> 41 once (counts read around it: two
   B3 launches), checking the output's shape and finiteness (step 10
   holds its values);
9. holds B2 against its plain version on both GCN layers' real tables at
   rtol = 1e-5, atol = 1e-5 * max|ref| (the same f32 terms summed in
   another order), and times it, its plain version and ``torch.sparse.mm``
   on the CSR adjacency;
10. holds B3 against its plain version on both GAT layers' real inputs, on
    4,096 dst rows spread over the graph (the first and last 512-row tiles
    included), at rtol = 1e-4, atol = 1e-5 * max|ref| (exponentials and
    sums in another order); holds each layer's output on those rows (the
    main path's output for the last layer) against the layer's plain
    forward at the same tolerance; and times B3 and its plain version (no
    PyTorch call computes B3);
11. times both forwards as a caller waits for them and breaks their device
    time down by kernel with ``torch.profiler``.

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
# the synthetic Reddit stand-in at full scale (dgl_tpu/data/synthetic.py:
# 205-223; 114,615,892 directed edges = 57,307,946 undirected pairs)
REDDIT_N, REDDIT_PAIRS = 232_965, 57_307_946
REDDIT_FEAT, REDDIT_CLASSES = 602, 41
GCN_HIDDEN = 16  # examples/reddit_fullgraph_gcn.py:48-54
GAT_HIDDEN, GAT_HEADS = 8, 8  # benchmarks/bench_reddit_gat.py:47-48
B3_CHECK_ROWS = 4096
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
    ``torch.profiler``, and the device's busy share of the wall time.

    The trace can lose the first launches after it starts, so one warm
    call runs inside the trace first and only kernels that start inside a
    ``record_function`` window around the ``iters`` calls count. Each
    kernel's entry gives its ms per call and the launches counted, so a lost
    launch would show as a short count."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
        with record_function("chip_smoke_window"):
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.events()
    start = min(ev.time_range.start for ev in events
                if ev.name == "chip_smoke_window")
    by_name: dict = {}
    for ev in events:
        if (ev.device_type == torch.autograd.DeviceType.CUDA
                and ev.name != "chip_smoke_window"
                and ev.time_range.start >= start):
            key = ev.name[:80]  # kernels whose names share it are summed
            us, n = by_name.get(key, (0.0, 0))
            by_name[key] = (us + ev.time_range.elapsed_us(), n + 1)
    busy_us = sum(us for us, _n in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    return {
        "wall_ms_per_call": wall_us / iters / 1e3,
        "device_busy_ms_per_call": busy_us / iters / 1e3,
        "device_idle_share": (1 - busy_us / wall_us) if busy_us else None,
        "kernels_ms_per_call": {k: v[0] / iters / 1e3 for k, v in top},
        "kernels_launches_in_trace": {k: v[1] for k, v in top},
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


def run_sage(rate: float, tag: dict) -> dict:
    """The GraphSAGE path (kernel B1); returns B1's entry of the kernel
    table."""
    import numpy as np
    import torch

    import dgl_tpu_torch as dt
    from dgl_tpu_torch import _kernels
    from dgl_tpu_torch.models import GraphSAGE
    from dgl_tpu_torch.ops import hub_spmm
    from dgl_tpu_torch.ops.shell_prefix import (shell_prefix_sum,
                                                shell_prefix_sum_plain)

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
    }


def reddit_graph(seed: int = 41):
    """The synthetic Reddit stand-in at full scale.

    The SBM recipe of ``dgl_tpu/data/synthetic.py:114-126`` (41 classes,
    homophily 0.8, seed 41) with 57,307,946 undirected pairs, put in both
    directions; self-loops removed, then one added per node, and duplicates
    removed (the dedup runs on the card). Features follow the recipe's
    gaussian mode (class centroids times 2 plus unit noise), 602 wide.
    Returns host int64 ``(src, dst)`` sorted by (dst, src) and the f32
    features on the card."""
    import numpy as np
    import torch

    n, e = REDDIT_N, REDDIT_PAIRS
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, REDDIT_CLASSES, n)
    src = rng.integers(0, n, e)
    intra = rng.random(e) < 0.8
    order = np.argsort(labels, kind="stable")
    gstart = np.searchsorted(labels[order], np.arange(REDDIT_CLASSES + 1))
    lo = gstart[labels[src]]
    width = np.maximum(gstart[labels[src] + 1] - lo, 1)
    same = order[lo + (rng.random(e) * width).astype(np.int64)]
    dst = np.where(intra, same, rng.integers(0, n, e))
    del intra, lo, width, same
    centroids = rng.normal(size=(REDDIT_CLASSES, REDDIT_FEAT)) * 2.0
    feat = (centroids[labels] + rng.normal(size=(n, REDDIT_FEAT))).astype(
        np.float32)
    s = torch.from_numpy(src).cuda()
    d = torch.from_numpy(dst).cuda()
    flat = torch.cat([d * n + s, s * n + d])
    del s, d
    flat = flat[flat // n != flat % n]
    loops = torch.arange(n, device=flat.device, dtype=torch.int64) * (n + 1)
    flat = torch.unique(torch.cat([flat, loops]))
    out = ((flat % n).cpu().numpy(), (flat // n).cpu().numpy(),
           torch.from_numpy(feat).cuda())
    del flat
    torch.cuda.empty_cache()
    return out


def bitmap_bound(bits, n_rows, other_bytes, flops, rate):
    """Least time of one call over the bitmap: its first ``n_rows`` rows
    read once (the padding rows below are never read) plus ``other_bytes``
    (the other inputs read once, the outputs written once) over the HBM
    rate, against ``flops`` f32 operations over the f32 rate."""
    bytes_ms = (n_rows * bits.shape[1] + other_bytes) / rate * 1e3
    ops_ms = flops / F32_RATE * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations")


def check_rows(n: int, count: int, seed: int = 3):
    """``count`` dst rows spread over the graph: the first and the last
    512-row tile and random rows between, sorted."""
    import numpy as np
    import torch

    edge = np.concatenate([np.arange(512), np.arange(n - 512, n)])
    rest = np.setdiff1d(np.arange(n), edge)
    mid = np.random.default_rng(seed).choice(rest, count - edge.size,
                                             replace=False)
    return torch.from_numpy(np.sort(np.concatenate([edge, mid]))).cuda()


def run_reddit(rate: float, tag: dict) -> list:
    """The Reddit-scale GCN and GAT paths (kernels B2 and B3); returns
    their entries of the kernel table."""
    import numpy as np
    import torch

    import dgl_tpu_torch as dt
    from dgl_tpu_torch import _kernels
    from dgl_tpu_torch.models import GAT, GCN
    from dgl_tpu_torch.ops.bitmap_gat import (_prep, bitmap_gat_fwd,
                                              gat_fwd_plain)
    from dgl_tpu_torch.ops.bitmap_spmm import (bitmap_matmul,
                                               bitmap_matmul_plain)

    torch.backends.cuda.matmul.allow_tf32 = False  # f32 references in f32
    torch.backends.cudnn.allow_tf32 = False
    N = REDDIT_N

    # 6. the graph and its plans, as examples/reddit_fullgraph_gcn.py:41-42
    t0 = time.perf_counter()
    src, dst, feat = reddit_graph()
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    g = dt.graph((src, dst), num_nodes=N)
    graph_s = time.perf_counter() - t0
    del src, dst
    t0 = time.perf_counter()
    gp = g.with_spmm_plans(num_hubs=256, bitmap=True,
                           bitmap_max_bytes=8 << 30)
    torch.cuda.synchronize()
    plans_s = time.perf_counter() - t0
    rel = gp._relation()
    plan = rel.bitmap_plan
    if plan is None or plan.bits_rev is not None:
        raise RuntimeError(f"expected one symmetric bitmap plan, got {plan}")
    E = rel.num_edges
    emit({"phase": "reddit_graph", "nodes": N, "edges": E,
          "density": E / N / N, "bitmap": repr(plan),
          "bitmap_bytes": plan.bits.numel(), "hub_plan": repr(rel.hub_plan),
          "data_s": gen_s, "graph_s": graph_s, "plans_s": plans_s,
          "setup_s": gen_s + graph_s + plans_s,
          "device_memory_gib": torch.cuda.memory_allocated() / 2**30, **tag})

    # 7. GCN(602, 16, 41): the main path, counts read around it, then the
    # exact f32 path (the graph without plans) as its reference
    gcn = GCN(REDDIT_FEAT, GCN_HIDDEN, REDDIT_CLASSES,
              generator=torch.Generator().manual_seed(0)).eval()
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launch_counts()
    with torch.inference_mode():
        out = gcn(gp, feat)
    torch.cuda.synchronize()
    gcn_launches = dict(_kernels.launch_counts)
    gcn_peak = torch.cuda.max_memory_allocated() / 2**30
    if gcn_launches["bitmap_spmm"] != 2:
        raise RuntimeError(f"GCN launched bitmap_spmm "
                           f"{gcn_launches['bitmap_spmm']} times, expected 2")
    with torch.inference_mode():
        ref = gcn(g, feat)
    torch.cuda.synchronize()
    if tuple(out.shape) != (N, REDDIT_CLASSES) or not torch.isfinite(
            out).all():
        raise RuntimeError(f"bad GCN output {tuple(out.shape)}")
    scale = ref.abs().max().item()
    err = (out - ref).abs().max().item()
    if not torch.allclose(out, ref, rtol=2e-2, atol=2e-2 * scale):
        raise RuntimeError(f"GCN bitmap path vs exact f32 path: max abs err "
                           f"{err} (max |ref| {scale})")
    emit({"phase": "gcn_main_path", "model": "GCN 602-16-41",
          "launches": gcn_launches, "peak_memory_gib": gcn_peak,
          "max_abs_err_vs_exact_f32": err, "max_rel_err": err / scale,
          "tolerance": "rtol=2e-2, atol=2e-2*max|ref|", **tag})
    del ref

    # 8. GAT(602, 8x8, 41): the main path, counts read around it
    gat = GAT(REDDIT_FEAT, GAT_HIDDEN, REDDIT_CLASSES, heads=GAT_HEADS,
              generator=torch.Generator().manual_seed(0)).eval()
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launch_counts()
    with torch.inference_mode():
        gout = gat(gp, feat)
    torch.cuda.synchronize()
    gat_launches = dict(_kernels.launch_counts)
    gat_peak = torch.cuda.max_memory_allocated() / 2**30
    if gat_launches["bitmap_gat_fwd"] != 2:
        raise RuntimeError(f"GAT launched bitmap_gat_fwd "
                           f"{gat_launches['bitmap_gat_fwd']} times, "
                           "expected 2")
    if tuple(gout.shape) != (N, REDDIT_CLASSES) or not torch.isfinite(
            gout).all():
        raise RuntimeError(f"bad GAT output {tuple(gout.shape)}")
    emit({"phase": "gat_main_path", "model": "GAT 602-8x8-41",
          "launches": gat_launches, "peak_memory_gib": gat_peak,
          "output_max_abs": gout.abs().max().item(), **tag})

    # 9. B2 against its plain version and torch.sparse.mm on both layers'
    # real tables (F = 16 each)
    bits = plan.bits
    with torch.inference_mode():
        nrm = 1.0 / torch.sqrt(torch.clamp(gp.out_degrees().float(), min=1))
        t0_tab = (feat * nrm[:, None]) @ gcn.conv0.weight
        h1 = torch.relu(gcn.conv0(gp, feat))
        tables = {"layer0 F=16": t0_tab, "layer1 F=16": h1 * nrm[:, None]}
        csc = rel.csc_indptr.long(), rel.csc_indices.long()
        adj = torch.sparse_csr_tensor(
            csc[0], csc[1], torch.ones(E, device=feat.device), size=(N, N))
    b2 = {}
    with torch.inference_mode():
        for label, t in tables.items():
            xb = t.to(torch.bfloat16).contiguous()
            xf = xb.float()
            got = bitmap_matmul(bits, xb, N)
            want = bitmap_matmul_plain(bits, xb, N)
            torch.cuda.synchronize()
            scale = max(want.abs().max().item(), 1e-30)
            abs_err = (got - want).abs().max().item()
            if not torch.allclose(got, want, rtol=1e-5, atol=1e-5 * scale):
                raise RuntimeError(f"B2 vs plain at {label}: max abs err "
                                   f"{abs_err} (max |ref| {scale})")
            lib_err = (torch.sparse.mm(adj, xf) - got).abs().max().item()
            feat_n = xb.shape[1]
            bound, bound_by = bitmap_bound(
                bits, N, N * feat_n * 2 + N * feat_n * 4, E * feat_n, rate)
            b2[label] = {
                "F": feat_n, "max_abs_err": abs_err,
                "max_rel_err": abs_err / scale,
                "ms": time_ms(lambda: bitmap_matmul(bits, xb, N), 20,
                              hide_host=True),
                "plain_ms": time_ms(lambda: bitmap_matmul_plain(bits, xb, N),
                                    2, warmup=1, hide_host=True),
                "library_ms": time_ms(lambda: torch.sparse.mm(adj, xf), 20,
                                      hide_host=True),
                "library_max_abs_err": lib_err,
                "bound_ms": bound, "bound_by": bound_by,
            }
            emit({"phase": "kernel_vs_plain", "kernel": "bitmap_spmm",
                  "shape": label, "n_dst": N, "edges": E,
                  "tolerance": "rtol=1e-5, atol=1e-5*max|ref|",
                  "library": "torch.sparse.mm(CSR adjacency, f32)",
                  **b2[label], **tag})
    del adj, tables, t0_tab

    # 10. B3 against its plain version on both layers' real inputs, on
    # B3_CHECK_ROWS dst rows spread over the graph
    rows = check_rows(N, B3_CHECK_ROWS)
    b3 = {}
    with torch.inference_mode():
        h0 = gat.gat0(gp, feat)
        # each layer's input, and its output on the model's own route: the
        # main path's output for the last layer
        layers = {"layer0 H=8 O=8": (gat.gat0, feat, h0),
                  "layer1 H=1 O=41": (gat.gat1, h0.reshape(N, -1), gout)}
        for label, (conv, x_in, y) in layers.items():
            heads, odim = conv.num_heads, conv.out_feats
            hs = conv.fc(x_in).reshape(-1, heads, odim)
            el = (hs * conv.attn_l).sum(-1)
            er = (hs * conv.attn_r).sum(-1)
            elp, erp, hp = _prep(plan, el, er, hs)
            slope = conv.negative_slope
            got, got_lse = bitmap_gat_fwd(bits, elp, erp, hp, slope, N)
            want, want_lse = gat_fwd_plain(bits[rows], elp, erp[rows], hp,
                                           slope)
            # the layer's plain forward on the check rows: the plain
            # attention, then the layer's residual, bias and activation,
            # and at the last layer the model's mean over heads
            y_want = conv._finish(want, x_in[rows], heads, odim)
            if y.dim() == 2:
                y_want = y_want.mean(dim=1)
            torch.cuda.synchronize()
            errs = {}
            for what, a, b in (("out", got[rows], want),
                               ("lse", got_lse[rows], want_lse),
                               ("layer_output", y[rows], y_want)):
                scale = max(b.abs().max().item(), 1e-30)
                errs[what] = (a - b).abs().max().item()
                if not torch.allclose(a, b, rtol=1e-4, atol=1e-5 * scale):
                    raise RuntimeError(f"B3 vs plain at {label} ({what}): "
                                       f"max abs err {errs[what]} "
                                       f"(max |ref| {scale})")
            # el, er and h over the N real rows read once; out and lse
            # written once
            io = (N * heads * 4 + N * heads * 4 + N * heads * odim * 2
                  + N * heads * odim * 4 + N * heads * 4)
            bound, bound_by = bitmap_bound(bits, N, io,
                                           E * heads * odim * 2, rate)
            b3[label] = {
                "H": heads, "O": odim, "max_abs_err": errs["out"],
                "max_abs_err_lse": errs["lse"],
                "max_abs_err_layer_output": errs["layer_output"],
                "ms": time_ms(lambda: bitmap_gat_fwd(bits, elp, erp, hp,
                                                     slope, N), 10,
                              hide_host=True),
                # one call of about a minute at layer 0: no warm-up (the
                # check above ran it on 4,096 rows)
                "plain_ms": time_ms(lambda: gat_fwd_plain(
                    bits[:N], elp, erp[:N], hp, slope), 1, warmup=0,
                    hide_host=True),
                "library_ms": None,
                "bound_ms": bound, "bound_by": bound_by,
            }
            emit({"phase": "kernel_vs_plain", "kernel": "bitmap_gat_fwd",
                  "shape": label, "n_dst": N, "checked_rows": len(rows),
                  "tolerance": "rtol=1e-4, atol=1e-5*max|ref|",
                  "library": "none: no single PyTorch call computes a "
                             "masked rank-1-logit softmax aggregation",
                  **b3[label], **tag})
            del hs, el, er, elp, erp, hp, got, got_lse, y_want
        del layers, h0

    # 11. both forwards as a caller waits for them, and where their device
    # time goes
    with torch.inference_mode():
        timing = {
            "gcn_forward_ms": time_ms(lambda: gcn(gp, feat), 5),
            "gat_forward_ms": time_ms(lambda: gat(gp, feat), 3),
            "gcn_exact_f32_path_forward_ms": time_ms(lambda: gcn(g, feat), 2),
        }
        emit({"phase": "reddit_timing", **timing, **tag})
        emit({"phase": "gcn_forward_profile", "calls": 3,
              **device_profile(lambda: gcn(gp, feat), 3), **tag})
        emit({"phase": "gat_forward_profile", "calls": 2,
              **device_profile(lambda: gat(gp, feat), 2), **tag})

    m2, m3 = b2["layer0 F=16"], b3["layer0 H=8 O=8"]
    return [{
        "name": "bitmap_spmm",
        "route": "cuda",
        "source": "dgl_tpu_torch/csrc/bitmap_spmm.cu",
        "replaces": "dgl_tpu/ops/bitmap_spmm.py:201",
        "launches": gcn_launches["bitmap_spmm"],
        "max_abs_err": max(v["max_abs_err"] for v in b2.values()),
        "ms": m2["ms"],
        "plain_ms": m2["plain_ms"],
        "bound_ms": m2["bound_ms"],
        "bound_by": m2["bound_by"],
        "library_ms": m2["library_ms"],
        "shape": f"GCN layer0 F=16, n_dst={N}, E={E}, times per call",
    }, {
        "name": "bitmap_gat_fwd",
        "route": "cuda",
        "source": "dgl_tpu_torch/csrc/bitmap_gat_fwd.cu",
        "replaces": "dgl_tpu/ops/bitmap_gat.py:121",
        "launches": gat_launches["bitmap_gat_fwd"],
        "max_abs_err": max(v["max_abs_err"] for v in b3.values()),
        "ms": m3["ms"],
        "plain_ms": m3["plain_ms"],
        "bound_ms": m3["bound_ms"],
        "bound_by": m3["bound_by"],
        "library_ms": None,
        "shape": f"GAT layer0 H=8 O=8, n_dst={N}, E={E}, times per call; "
                 f"layer1 H=1 O=41: {b3['layer1 H=1 O=41']['ms']} ms",
    }]


def run() -> dict:
    import torch

    from dgl_tpu_torch import _kernels

    card = card_info()
    rate = hbm_rate(torch.cuda.get_device_name(0))
    tag = {"card": card}

    # 1. build the kernels from the checkout's sources (one nvcc each,
    # started together)
    t0 = time.perf_counter()
    _kernels.library()
    emit({"phase": "build", "kernels": sorted(_kernels.launch_counts),
          "seconds": time.perf_counter() - t0, **tag})

    kernels = [run_sage(rate, tag)]
    kernels += run_reddit(rate, tag)
    return {"kernels": kernels, "card": card}


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
