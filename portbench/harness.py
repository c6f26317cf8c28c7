"""One run of one cell: set-up, the measured window, the traced segment,
the comparison with the reference, and the result line.

Set-up makes the inputs and weights from the seed on the device, builds
the system through the configuration family's builder, and warms up the
cell's own call: a training cell runs its first three steps (the ones
that are compared), a serving cell three forwards. The window then runs
the call back to back for ``--seconds``:

- ``train``: full-graph steps (forward, masked cross-entropy, backward,
  ``torch.optim.Adam.step``) in a closed loop, ended by a synchronise;
  ``train_step_ms`` is the window's time over its steps;
- ``infer``: full-graph forwards under ``torch.inference_mode``, each
  synchronised; ``infer_ms`` is the window's time over its forwards and
  ``infer_p95_ms`` the 95th percentile of each forward's span on the
  host's clock, from its call to the return of its synchronise.

With ``--trace 1`` the same window runs, then a traced segment of the
mix's ``trace_steps`` calls, and the line carries the cell's per-layer
metrics instead of its end-to-end ones. A training cell then runs one more
step, which is compared with a reference step (``check``).
"""
from __future__ import annotations

import gc
import math
import random
import subprocess
import sys
import time
from types import SimpleNamespace

import torch
import torch.nn.functional as F

from . import check, inputs as inputs_mod, peaks, roofline, spec, trace
from .builders import cold_tail
from .reference.common import Precision

WARM_FORWARDS = 3
KEPT_FORWARDS = 2  # forwards kept for the comparison besides the last


def say(msg: str) -> None:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)


def masked_loss(logits, y, mask):
    """The training loss as the port's examples write it: softmax
    cross-entropy averaged over the masked nodes."""
    ce = F.cross_entropy(logits, y, reduction="none")
    return (ce * mask).sum() / mask.sum()


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError) as e:
        return f"not read ({e.__class__.__name__})"
    return out.strip().splitlines()[0].strip()


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _p95(values) -> float:
    s = sorted(values)
    return s[max(math.ceil(0.95 * len(s)) - 1, 0)]


def run_cell(r: dict, seed: int, seconds: float, traced: bool,
             device="cuda", t_start: float | None = None,
             detail: dict | None = None, post: dict | None = None) -> dict:
    """Run the resolved cell ``r`` once; returns the result line's object.
    ``detail``, where given, gets readings that are not compared (the
    later steps' losses); ``post`` gets a training cell's snapshot before
    its step past the window and the program's node order, from which
    ``control.py`` reads the controls. On the CPU (the tests) there is no
    trace."""
    t_start = time.perf_counter() if t_start is None else t_start
    cfg = {**r["cfg"], "graph": spec.graph_spec(r)}
    fam = spec.reference(cfg["family"])
    mode = r["mix"]["mode"]
    cuda = torch.device(device).type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- set-up ------------------------------------------------------------
    t_run = time.perf_counter()
    inputs, weights, dropout_seed = inputs_mod.make(
        cfg["graph"], fam.param_shapes(cfg), seed, device)
    num_nodes, edges = dict(inputs.num_nodes), inputs.edge_counts()
    sync(device)
    t_inputs = time.perf_counter()
    system = spec.builder(cfg["family"]).build(cfg, inputs, weights, device)
    del inputs
    sync(device)
    t_built = time.perf_counter()
    model = system.model
    if mode == "train":
        model.train()
        opt = torch.optim.Adam(model.parameters(), lr=cfg["lr"])

        def call(spans=trace.no_spans):
            opt.zero_grad(set_to_none=True)
            with spans("forward"):
                logits = system.forward()
            with spans("loss"):
                loss = masked_loss(logits, system.labels, system.train_mask)
            with spans("backward"):
                loss.backward()
            with spans("optimizer"):
                opt.step()
            return loss.detach()

        got = check.program_train(call, opt, model, weights, dropout_seed,
                                  device)
    else:
        model.eval()

        def call(spans=trace.no_spans):
            with torch.inference_mode():
                with spans("forward"):
                    out = system.forward()
                with spans("sync"):
                    sync(device)
            return out

        for _ in range(WARM_FORWARDS):
            call()
    sync(device)
    setup_s = time.perf_counter() - t_start
    say(f"setup_s {setup_s:.3f}: start {t_run - t_start:.3f}, inputs "
        f"{t_inputs - t_run:.3f}, build {t_built - t_inputs:.3f}, warm "
        f"{t_start + setup_s - t_built:.3f}")
    setup_peak = torch.cuda.max_memory_allocated() if cuda else 0

    # -- the window ----------------------------------------------------------
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    kept, spans_ms = {}, []
    keep = set(random.Random(seed).sample(range(1, 64), KEPT_FORWARDS))
    n = 0
    t0 = time.perf_counter()
    if mode == "train":
        while True:
            last = call()
            n += 1
            if time.perf_counter() - t0 >= seconds:
                break
        sync(device)
        window_s = time.perf_counter() - t0
        if not math.isfinite(float(last)):
            raise RuntimeError(f"the window's last loss is {float(last)}")
    else:
        with torch.inference_mode():
            while True:
                h0 = time.perf_counter()
                out = system.forward()
                sync(device)
                spans_ms.append((time.perf_counter() - h0) * 1e3)
                if n in keep:
                    kept[n] = out
                n += 1
                if time.perf_counter() - t0 >= seconds:
                    break
        window_s = time.perf_counter() - t0
        kept["last"] = out
        del out
    window_peak = torch.cuda.max_memory_allocated() if cuda else 0
    step_s = window_s / n
    if mode == "train":
        e2e = {"setup_s": setup_s, "train_step_ms": step_s * 1e3}
    else:
        e2e = {"setup_s": setup_s, "infer_ms": step_s * 1e3,
               "infer_p95_ms": _p95(spans_ms)}

    # -- the traced segment --------------------------------------------------
    summary = None
    if traced:
        summary = trace.profile_segment(call, int(r["mix"]["trace_steps"]))
        tails = {rel: {"fwd": cold_tail(p, False), "bwd": cold_tail(p, True)}
                 for rel, p in system.plans.items()}
    if mode == "train":
        snap, got_w = check.program_step(call, opt, model, device)
    row_order = (None if system.row_order is None
                 else system.row_order.clone())
    del system, model, call
    if mode == "train":
        del opt, last
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # -- the comparison ------------------------------------------------------
    t_ref = time.perf_counter()
    ref_inputs, ref_weights, _ = inputs_mod.make(
        cfg["graph"], fam.param_shapes(cfg), seed, device)
    if row_order is not None and not torch.equal(
            torch.sort(row_order).values,
            torch.arange(row_order.numel(), device=row_order.device)):
        raise RuntimeError("the program's node order is not a permutation")
    prec = Precision.stated(cfg)
    if mode == "train":
        ref = check.reference_train(fam, cfg, ref_inputs, ref_weights,
                                    row_order, dropout_seed, prec, device)
        ref_w = check.reference_step(fam, cfg, ref_inputs, snap, row_order,
                                     prec, device)
        numbers = check.train_numbers(got, ref, got_w, ref_w, detail)
        if post is not None:
            post.update(snapshot=snap, row_order=row_order)
    else:
        with torch.no_grad():
            ref = fam.forward(cfg, ref_weights, ref_inputs, prec)
        numbers = check.logits_numbers(kept.values(), ref, row_order)
    correct, failed, checks = check.verdict(numbers, r["limits"])
    sync(device)
    say(f"comparison {time.perf_counter() - t_ref:.3f} s after the window")

    # -- the line ------------------------------------------------------------
    name = torch.cuda.get_device_name(0) if cuda else "cpu"
    device_info = {"platform": "gpu" if cuda else "cpu", "kind": name,
                   "count": 1,
                   "memory_peak_bytes": max(setup_peak, window_peak)}
    if traced:
        pk = peaks.of(name)
        work = fam.work(cfg, num_nodes, edges, mode)
        ctx = SimpleNamespace(
            step_s=step_s, flops=work["flops"], peaks=pk,
            b1_least_s=roofline.b1_least_per_step(work["aggs"], tails, pk),
            trace=summary, window_peak_bytes=window_peak)
        metrics = {}
        for m in r["per_layer"]:
            value = spec.metric_reader(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device_info.update(busy_s=summary["busy_s"],
                           window_s=summary["window_s"])
    else:
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in r["end_to_end"]}
    result = {"correct": correct, "attempted": n, "failed": failed,
              "metrics": metrics, "device": device_info}
    if traced:
        result["breakdown"] = trace.breakdown(summary)
    result["checks"] = checks
    return result
