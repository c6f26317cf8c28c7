"""The readings that the limits of ``limits/<workload>.json`` are set from,
in one process:

- ``program``: the program against the reference, as a run compares them
  (``harness.run_cell`` with a window of ``--seconds``), one a seed;
- the controls, each the reference in the program's place one precision
  step below the configuration's stated one, against the reference:
  ``tf32`` (the linears in TF32), ``fp8_rows`` (the gathered rows in
  float8 e4m3) and ``control`` (both). Every one has to fail a number of
  the cell;
- the faults a cell can have, planted in the reference in the program's
  place: ``half_batch`` (the loss over half of the train nodes),
  ``unchanged_state`` (a step that leaves the parameters as they were),
  ``altered_answer`` (one node's logits negated where they are produced);
- ``sum_order``: the reference in the program's place at the stated
  precision, its edge lists in another order, so its f32 sums add in
  another order. Not a control: it shows how far the comparison moves
  where only the order of the sums differs (a bf16 row that rounds the
  other way on one side), the floor under the program's readings.

A training cell's readings of the step past the window start from the
program's own snapshot of that seed's run (``run_cell``'s ``post``).

    python3 portbench/control.py --workload <cell> --seeds 1 2 3 ...
        [--control-seeds 1 2 3] [--seconds 1] [--out readings.jsonl]

Prints one JSON line a reading, then the largest ``program`` reading and
the smallest of the others for each number. Needs a card, as a run does.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def reference_readings(r: dict, seed: int, device, post=None) -> list:
    """The controls' and the faults' readings on one seed; a training
    cell needs ``post`` from the program's run of the seed."""
    import torch

    from portbench import check, inputs as inputs_mod, spec
    from portbench.reference.common import CONTROLS, Precision

    cfg = {**r["cfg"], "graph": spec.graph_spec(r)}
    fam = spec.reference(cfg["family"])
    mode = r["mix"]["mode"]
    inputs, weights, dseed = inputs_mod.make(
        cfg["graph"], fam.param_shapes(cfg), seed, device)
    stated = Precision.stated(cfg)
    g = torch.Generator(device=device).manual_seed((seed + 1) % 2**64)
    reordered = dataclasses.replace(inputs, relations={
        cet: tuple(t[p] for t in (src, dst))
        for cet, (src, dst) in inputs.relations.items()
        for p in [torch.randperm(src.numel(), device=device, generator=g)]})
    out = []
    if mode == "train":
        snap, order = post["snapshot"], post["row_order"]

        def run(prec, mask=None, inp=inputs):
            return (check.reference_train(fam, cfg, inp, weights, order,
                                          dseed, prec, device, mask),
                    check.reference_step(fam, cfg, inp, snap, order,
                                         prec, device, mask))
        ref, ref_w = run(stated)
        half = inputs.train_mask.clone()
        on = torch.nonzero(half).flatten()
        g = torch.Generator(device=on.device).manual_seed(seed % 2**64)
        drop = on[torch.randperm(on.numel(), device=on.device,
                                 generator=g)[:on.numel() // 2]]
        half[drop] = 0
        got = {kind: run(prec) for kind, prec in CONTROLS.items()}
        got["sum_order"] = run(stated, inp=reordered)
        got["half_batch"] = run(stated, half)
        got["unchanged_state"] = tuple(
            {**x, "change_norms": {k: 0.0 for k in x["change_norms"]}}
            for x in (ref, ref_w))
        for kind, (reading, reading_w) in got.items():
            detail = {}
            out.append((kind, check.train_numbers(reading, ref, reading_w,
                                                  ref_w, detail)))
            out.append((kind + "_detail", detail))
    else:
        with torch.no_grad():
            ref = fam.forward(cfg, weights, inputs, stated)
            for kind, prec in CONTROLS.items():
                got = fam.forward(cfg, weights, inputs, prec)
                out.append((kind, check.logits_numbers([got], ref, None)))
            got = fam.forward(cfg, weights, reordered, stated)
            out.append(("sum_order", check.logits_numbers([got], ref, None)))
            bad = ref.clone()
            row = seed % bad.shape[0]
            bad[row] = -bad[row]
            out.append(("altered_answer",
                        check.logits_numbers([bad], ref, None)))
    return out


def summarise(lines: list) -> dict:
    """Per number: the largest ``program`` reading and the smallest
    reading of each other kind."""
    out: dict = {}
    for ln in lines:
        if ln["kind"].endswith("_detail"):
            continue
        for k, v in ln["numbers"].items():
            slot = out.setdefault(k, {})
            if ln["kind"] == "program":
                slot["program_max"] = max(slot.get("program_max", 0.0), v)
            else:
                key = ln["kind"] + "_min"
                slot[key] = min(slot.get(key, float("inf")), v)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, nargs="*", default=None)
    p.add_argument("--seconds", type=float, default=0.0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from portbench import harness, spec

    if not torch.cuda.is_available():
        harness.say("needs a CUDA card")
        return 2
    r = spec.resolve(spec.load_spec(), args.workload)
    lines = []

    def emit(kind, seed, numbers):
        ln = {"workload": args.workload, "seed": seed, "kind": kind,
              "numbers": numbers}
        lines.append(ln)
        print(json.dumps(ln), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(ln) + "\n")

    control_seeds = (args.seeds[:3] if args.control_seeds is None
                     else args.control_seeds)
    posts = {}
    for seed in dict.fromkeys(args.seeds + control_seeds):
        detail, post = {}, {}
        res = harness.run_cell(r, seed, args.seconds, False, "cuda",
                               detail=detail, post=post)
        emit("program", seed, {k: c["value"]
                               for k, c in res["checks"].items()})
        if detail:
            emit("program_detail", seed, detail)
        if seed in control_seeds:
            posts[seed] = post
    for seed in control_seeds:
        for kind, numbers in reference_readings(r, seed, "cuda",
                                                posts[seed]):
            emit(kind, seed, numbers)
        torch.cuda.empty_cache()
    print(json.dumps({"workload": args.workload,
                      "summary": summarise(lines)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
