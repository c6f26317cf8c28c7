"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout. The last line of standard output is one JSON
object (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` ``breakdown``, and last ``checks``: each number compared
beside its limit, which also close standard error). The card's name, the
device count and its power limit go to standard error first.

No result is printed, and the exit code is not 0, where CUDA has no card
or fewer than the cell asks for, where the program cannot be imported,
where a run fails, or where ``jax``, ``jaxlib``, ``flax`` or ``dgl_tpu``
(whole top-level module names) is loaded once the window has closed.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "dgl_tpu")


def forbidden_modules(modules=None) -> list:
    """The loaded modules whose top-level name, the part before the first
    dot, is one of ``FORBIDDEN`` as a whole (``dgl_tpu_torch`` is not
    ``dgl_tpu``)."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    # the program's kernel caches stay inside the checkout, at fixed paths
    cache = os.path.join(ROOT, "build", "portbench")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache,
                                                      "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    sys.path.insert(0, ROOT)
    import torch

    from portbench import harness, spec

    r = spec.resolve(spec.load_spec(), args.workload)
    chips = int(r["workload"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        harness.say(f"needs {chips} CUDA card(s); torch.cuda.is_available()="
                    f"{torch.cuda.is_available()}, device_count="
                    f"{torch.cuda.device_count()}")
        return 2
    result = harness.run_cell(r, args.seed, args.seconds, bool(args.trace),
                              "cuda", T_START)
    harness.say(f"card {torch.cuda.get_device_name(0)}; devices "
                f"{torch.cuda.device_count()}; nvidia-smi name, power limit: "
                f"{harness.power_limit()}")
    found = forbidden_modules()
    if found:
        harness.say(f"modules loaded that the port may not load: {found}")
        return 3
    for k, c in result["checks"].items():
        harness.say(f"check {k} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
