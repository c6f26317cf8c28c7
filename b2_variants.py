#!/usr/bin/env python3
"""Time the bitmap SpMM (kernel B2, ``dgl_bitmap_spmm``, and its f32
instantiation B2f) built from variants of its source, in turns on one
NVIDIA GPU, at the Reddit GCN's shapes that ``chip_smoke.py`` records.

    python3 b2_variants.py [--out FILE]

Run it from the root of a checkout, on a machine with a CUDA card. Each
variant is ``dgl_tpu_torch/csrc/bitmap_spmm.cu`` with one change
(``VARIANTS``): "this" is the source as it is, "ids by __ldg" reads each
chunk's ids straight from device memory with a plain load where they are
used, in place of ``edge_ring.cuh``'s cp.async ring two chunks ahead. Each
is compiled on its own with ``nvcc`` (the build's flags, ``-Xptxas -v``),
all at once, into a library of its own under ``build/b2_variants``
(``b1_variants.build``). Then,
shape by shape, every variant's library takes the port's wrapper
(``bitmap_matmul`` over the relation's CSC) in turns, forward then
backward through the list (a, b, ..., b, a): its result must equal the
first variant's to the bit (the same f32 terms in the same order) and
``torch.sparse.mm``'s within 1e-5 * max|ref| (another order), and its
device time is taken with ``chip_smoke.time_ms`` (launches back to back,
host hidden).

The shapes: the synthetic Reddit stand-in (``chip_smoke.reddit_graph``,
232,965 nodes, 111,687,357 edges) at F = 16, x in bf16 (B2) and in f32
(B2f), random (seed 0); each prints its bound over the CSC
(``chip_smoke.b2_figures``) beside the times. The graph is symmetric, so
the backward walks a CSR of the same shape.

Prints one JSON object a line (``ptxas`` per variant, then one a shape)
and writes them all to ``--out`` (default ``build/b2_variants/times.jsonl``).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(ROOT, "dgl_tpu_torch", "csrc", "bitmap_spmm.cu")
BUILD = os.path.join(ROOT, "build", "b2_variants")
sys.path.insert(0, ROOT)

from b1_variants import _sub, build  # noqa: E402

# name -> the change to the source; "this" is the source as it is
VARIANTS = {
    "this": lambda text: text,
    "ids by __ldg": _sub(
        (r"edge_ring::walk_ids<C>\(ids_sh\[warp\], indices, beg, end, "
         r"lane, chunk\);",
         "for (int c0 = beg; c0 < end; c0 += C) chunk(c0, indices + c0);"),
        (r"const int s = ids\[t \* P \+ lane / G\];",
         "const int j = t * P + lane / G;\n"
         "      const int s = c0 + j < end ? __ldg(ids + j) : -1;")),
}


def shapes(rate: float) -> list:
    """(label, call, library call, bound figures) at Reddit's shapes."""
    import numpy as np
    import torch

    import chip_smoke as cs
    import dgl_tpu_torch as dt
    from dgl_tpu_torch.ops.bitmap_spmm import bitmap_matmul

    src, dst, feat, _labels, _mask = cs.reddit_graph()
    del feat
    rel = dt.graph((src, dst), num_nodes=cs.REDDIT_N)._relation()
    del src, dst
    N, E = cs.REDDIT_N, rel.num_edges
    idx = {"indptr": rel.csc_indptr, "indices": rel.csc_indices}
    adj = torch.sparse_csr_tensor(
        rel.csc_indptr.long(), rel.csc_indices.long(),
        torch.ones(E, device="cuda"), size=(N, N))
    rng = np.random.default_rng(0)
    out = []
    for label, dtype, cd in (("B2 F=16", torch.bfloat16, "bfloat16"),
                             ("B2f F=16", torch.float32, "float32")):
        x = torch.from_numpy(rng.normal(size=(N, 16)).astype(
            np.float32)).cuda().to(dtype)
        out.append((label, lambda x=x, cd=cd: bitmap_matmul(
            None, x, N, cd, **idx),
            lambda x=x: torch.sparse.mm(adj, x.float()),
            cs.b2_figures(rel, 16, dtype, rate, "fwd")))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join(BUILD, "times.jsonl"))
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("b2_variants: no CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from dgl_tpu_torch import _kernels

    text = open(SOURCE).read()
    variants = {name: change(text) for name, change in VARIANTS.items()}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    lines = []

    def emit(obj):
        lines.append(obj)
        print(json.dumps(obj), flush=True)

    card = cs.card_info()
    rate = cs.hbm_rate(torch.cuda.get_device_name(0))
    t0 = time.perf_counter()
    libs = build(variants, BUILD, lambda key: key.startswith("T="))
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "ptxas": {n: r for n, (_l, r) in libs.items()}, "card": card})
    t0 = time.perf_counter()
    cases = shapes(rate)
    emit({"phase": "inputs", "seconds": time.perf_counter() - t0,
          "card": card})
    order = list(libs) + list(libs)[::-1]
    with torch.inference_mode():
        for label, kern, library, fig in cases:
            want = library()
            scale = want.abs().max().item()
            first = None
            times = {n: [] for n in libs}
            _kernels._lib = libs[order[0]][0]
            cs.time_ms(kern, 20, hide_host=True)  # warm-up, not kept
            for name in order:
                _kernels._lib = libs[name][0]
                got = kern()
                torch.cuda.synchronize()
                first = got if first is None else first
                if not torch.equal(got, first):
                    raise RuntimeError(f"{label}: variant {name!r} differs "
                                       f"from {order[0]!r}")
                if not torch.allclose(got, want, rtol=1e-5,
                                      atol=1e-5 * scale):
                    raise RuntimeError(
                        f"{label}: variant {name!r} differs from "
                        f"torch.sparse.mm by "
                        f"{(got - want).abs().max().item()}")
                times[name].append(cs.time_ms(kern, 50, hide_host=True))
            ms = {n: sum(t) / len(t) for n, t in times.items()}
            emit({"shape": label, "ms": ms, "turns_ms": times,
                  "library_ms": cs.time_ms(library, 20, hide_host=True),
                  **fig, "share_of_bound": {
                      n: fig["bound_ms"] / t for n, t in ms.items()},
                  "card": card})
    _kernels._lib = None
    with open(args.out, "w") as f:
        for obj in lines:
            f.write(json.dumps(obj) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
