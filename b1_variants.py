#!/usr/bin/env python3
"""Time the shell prefix sum (kernel B1, ``dgl_shell_prefix_sum``, and
its f32 instantiation B1f) built from variants of its source, in turns on
one NVIDIA GPU, at the shapes ``chip_smoke.py`` records for it.

    python3 b1_variants.py [--parent PATH] [--out FILE]

Run it from the root of a checkout, on a machine with a CUDA card. Each
variant is ``dgl_tpu_torch/csrc/shell_prefix_sum.cu`` with one change
(``VARIANTS``), or with ``--parent`` another version of that file (an
earlier commit's). Each is compiled on its own with ``nvcc`` (the build's
flags, ``-Xptxas -v``), all at once, into a library of its own under
``build/b1_variants``. Then, shape by shape, every variant's library
takes the port's wrappers (``shell_prefix_sum``, ``shell_prefix_gspmm``)
in turns, forward then backward through the list (a, b, ..., b, a): its
result must equal the plain version's to the bit, and its device time is
taken with ``chip_smoke.time_ms`` (launches back to back, host hidden).

The shapes: the GraphSAGE path's (the arxiv-scale zipf graph, its int8
hub plan: the forward shells at F = 128, 256, 40 and the reverse ones,
with the residual as base, at F = 256, 40), B1f on the same shells (f32
tables: forward F = 256, reverse F = 40), the R-GCN's on ogbn-mag's
counts (``writes`` and ``affiliated_with`` both ways, F = 64), and the
weighted caller B1w (``u_mul_e`` over the weighted shell plan of the
zipf graph plus self-loops: forward F = 128, 256, 40, reverse F = 256,
40), whose code the variants share in part. Tables are random (seed 0);
each shape prints its bound and gather-stream figure
(``chip_smoke.kernel_bound``) beside the times.

Prints one JSON object a line (``ptxas`` per variant, then one a shape)
and writes them all to ``--out`` (default ``build/b1_variants/times.jsonl``).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(ROOT, "dgl_tpu_torch", "csrc", "shell_prefix_sum.cu")
BUILD = os.path.join(ROOT, "build", "b1_variants")


def _sub(*pairs):
    """The change that replaces each ``(pattern, repl)`` of ``pairs`` in
    the source; each pattern must match exactly once."""
    def apply(text):
        for pattern, repl in pairs:
            text, n = re.subn(pattern, repl, text, flags=re.S)
            if n != 1:
                raise RuntimeError(f"variant pattern {pattern!r} matched "
                                   f"{n} times")
        return text
    return apply


def _group(n):
    """kSumGroup levels' row loads in flight a thread (f32 rows half as
    many)."""
    return (r"constexpr int kSumGroup = \d+;",
            f"constexpr int kSumGroup = {n};")


def _blocks(n):
    """At least n blocks an SM: registers capped at 65,536 / (256 n)."""
    return (r"__launch_bounds__\(kWarps \* 32\) shell_prefix_sum_kernel\(",
            f"__launch_bounds__(kWarps * 32, {n}) shell_prefix_sum_kernel(")


def _stage(n):
    """n index slots a lane stages at once."""
    return (r"constexpr int kSumStage = \d+;",
            f"constexpr int kSumStage = {n};")


# name -> the change to the source; "this" is the source as it is
VARIANTS = {
    "this": lambda text: text,
    "group 2": _sub(_group(2)),
    "group 8": _sub(_group(8)),
    "blocks 8": _sub(_blocks(8)),
    "stage 2": _sub(_stage(2)),
    "stage 8": _sub(_stage(8)),
    # the output stored without the streaming hint
    "plain store": _sub((r"(// The output row, stored with the streaming hint)",
                         "#define __stcs(p, v) (*(p) = (v))\n\\1")),
    # the table rows loaded with an L2 evict-last policy
    "evict-last rows": _sub((
        r"(template <typename T, int VEC>\n__device__ __forceinline__ void "
        r"load_row\(.*?)__ldg\(q \+ h\)",
        r"""__device__ __forceinline__ uint4 ld_evict_last(const uint4* p) {
  uint64_t pol;
  asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(pol));
  uint4 v;
  asm("ld.global.nc.L2::cache_hint.v4.u32 {%0, %1, %2, %3}, [%4], %5;"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p), "l"(pol));
  return v;
}

\1ld_evict_last(q + h)""")),
}


def build(variants: dict, out_dir: str = BUILD,
          keep=lambda key: key.startswith("sum ")) -> dict:
    """Compile each variant's source into a library under ``out_dir`` (all
    ``nvcc`` at once, ``csrc/`` on the include path); returns ``{name:
    (ctypes library, ptxas report of the instantiations whose key
    ``keep`` holds)}``."""
    import chip_smoke as cs
    from torch.utils.cpp_extension import CUDA_HOME

    from dgl_tpu_torch import _kernels

    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for i, (name, text) in enumerate(variants.items()):
        src = os.path.join(out_dir, f"v{i}.cu")
        with open(src, "w") as f:
            f.write(text)
        procs[name] = (subprocess.Popen(
            [os.path.join(CUDA_HOME, "bin", "nvcc"), *_kernels.CUDA_FLAGS,
             "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas",
             "-v", "-I", os.path.dirname(SOURCE), "-o",
             os.path.join(out_dir, f"v{i}.so"), src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            os.path.join(out_dir, f"v{i}.so"))
    out = {}
    for name, (proc, path) in procs.items():
        report = cs.ptxas_report(proc)
        lib = ctypes.CDLL(path)
        for fn, argtypes in _kernels.ARGTYPES.items():
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
        out[name] = (lib, {k: v for k, v in report.items() if keep(k)})
    return out


def hub_shapes(rate: float) -> list:
    """B1's and B1f's shapes: (label, call, plain call, bound, stream)."""
    import numpy as np
    import torch

    import chip_smoke as cs
    import dgl_tpu_torch as dt
    from dgl_tpu_torch.ops import hub_spmm
    from dgl_tpu_torch.ops.shell_prefix import (shell_prefix_sum,
                                                shell_prefix_sum_plain)

    rng = np.random.default_rng(0)
    shapes = []

    def add(label, plan, reverse, feat, dtype):
        flat, rows, levels, _res, _unrank, n_out = plan.direction(reverse)
        n_table = plan.num_dst if reverse else plan.num_src
        xg = torch.from_numpy(rng.normal(size=(n_table, feat)).astype(
            np.float32)).cuda().to(dtype)
        base = hub_spmm._residual_base(xg, plan, reverse)
        _bi, _bo, n_cold, used = cs.cold_bags(plan, reverse)
        bound, _by, stream = cs.kernel_bound(
            rows, n_out, used, n_cold, feat, base is not None, rate,
            elem=xg.element_size())
        shapes.append((label, lambda: shell_prefix_sum(
            xg, flat, rows, n_out, base=base, levels=levels),
            lambda: shell_prefix_sum_plain(xg, flat, rows, n_out, base=base),
            bound, stream, len(rows)))

    src, dst = cs.zipf_graph(0)
    g = dt.graph((src, dst), num_nodes=cs.N_NODES)
    gp, _perm = dt.transforms.reorder_for_spmm(g, num_hubs=2048,
                                               precision="int8")
    plan = gp._relation().hub_plan
    for f in (128, 256, 40):
        add(f"arxiv fwd F={f}", plan, False, f, torch.bfloat16)
    for f in (256, 40):
        add(f"arxiv bwd F={f}", plan, True, f, torch.bfloat16)
    add("B1f arxiv fwd F=256", plan, False, 256, torch.float32)
    add("B1f arxiv bwd F=40", plan, True, 40, torch.float32)
    del g, gp
    mag = cs.mag_graph()
    gm = dt.heterograph(mag["data"], mag["nodes"]).with_spmm_plans(
        num_hubs=2048)
    del mag
    for cet, rel in gm._relations.items():
        if cet[1] in ("writes", "affiliated_with"):
            for reverse in (False, True):
                add(f"mag {cet[1]} {'bwd' if reverse else 'fwd'} F=64",
                    rel.hub_plan, reverse, cs.MAG_HIDDEN, torch.bfloat16)
    return shapes


def weighted_shapes(rate: float) -> list:
    """B1w's ``u_mul_e`` shapes over the weighted shell plan."""
    import numpy as np
    import torch

    import chip_smoke as cs
    import dgl_tpu_torch as dt
    from dgl_tpu_torch.ops.shell_prefix import (shell_prefix_gspmm,
                                                shell_prefix_gspmm_plain)
    from dgl_tpu_torch.ops.shell_spmm import _residual_base

    rng = np.random.default_rng(1)
    src, dst = cs.zipf_loops_graph()
    gp = dt.graph((src, dst), num_nodes=cs.N_NODES).with_spmm_plans(
        num_hubs=2048, weighted=True)
    plan = gp._relation().shell_plan
    w = torch.from_numpy(rng.random((int(plan.emask.shape[0]), 1)).astype(
        np.float32)).cuda().to(torch.bfloat16)
    shapes = []
    for reverse, feats in ((False, (128, 256, 40)), (True, (256, 40))):
        lay, res, _unrank, n_out = plan.direction(reverse)
        rank = plan.rank_src if reverse else plan.rank_dst
        n_table = plan.num_dst if reverse else plan.num_src
        for f in feats:
            u = torch.from_numpy(rng.normal(size=(n_table, f)).astype(
                np.float32)).cuda().to(torch.bfloat16)
            base = _residual_base("mul", u, w, res, n_out)
            args = ("mul", u, w, lay.nidx, lay.eidx, lay.level_rows,
                    lay.level_real, n_out)
            shapes.append((
                f"B1w u_mul_e {'bwd' if reverse else 'fwd'} F={f}",
                lambda a=args, b=base, r=rank, lv=lay.levels:
                    shell_prefix_gspmm(*a, base=b, levels=lv, rank=r),
                lambda a=args, b=base, r=rank:
                    shell_prefix_gspmm_plain(*a, base=b, rank=r),
                None, None, len(lay.level_rows)))
    return shapes


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="another version of "
                    "shell_prefix_sum.cu, timed as the variant 'parent'")
    ap.add_argument("--out", default=os.path.join(BUILD, "times.jsonl"))
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("b1_variants: no CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from dgl_tpu_torch import _kernels

    text = open(SOURCE).read()
    variants = {}
    if args.parent:
        variants["parent"] = open(args.parent).read()
    variants.update({name: change(text) for name, change in VARIANTS.items()})
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    lines = []

    def emit(obj):
        lines.append(obj)
        print(json.dumps(obj), flush=True)

    card = cs.card_info()
    rate = cs.hbm_rate(torch.cuda.get_device_name(0))
    t0 = time.perf_counter()
    libs = build(variants)
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "ptxas": {n: r for n, (_l, r) in libs.items()}, "card": card})
    t0 = time.perf_counter()
    shapes = hub_shapes(rate) + weighted_shapes(rate)
    emit({"phase": "inputs", "seconds": time.perf_counter() - t0,
          "card": card})
    order = list(libs) + list(libs)[::-1]
    with torch.inference_mode():
        for label, kern, plain, bound, stream, n_levels in shapes:
            want = plain()
            times = {n: [] for n in libs}
            _kernels._lib = libs[order[0]][0]
            cs.time_ms(kern, 50, hide_host=True)  # warm-up, not kept
            for name in order:
                _kernels._lib = libs[name][0]
                got = kern()
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    raise RuntimeError(
                        f"{label}: variant {name!r} differs from the plain "
                        f"version by {(got - want).abs().max().item()}")
                times[name].append(cs.time_ms(kern, 50, hide_host=True))
            ms = {n: sum(t) / len(t) for n, t in times.items()}
            emit({"shape": label, "levels": n_levels, "ms": ms,
                  "turns_ms": times, "bound_ms": bound,
                  "gather_stream_bound_ms": stream,
                  "share_of_bound": None if bound is None else {
                      n: bound / t for n, t in ms.items()},
                  "card": card})
    _kernels._lib = None
    with open(args.out, "w") as f:
        for obj in lines:
            f.write(json.dumps(obj) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
