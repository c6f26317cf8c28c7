"""``BENCHMARK.json`` and the files it names: loading, the rules on names,
and the resolution of a cell into its configuration, traffic mix, limits,
metrics, builder, reference and metric readers.

Everything that belongs to one configuration, mix, cell or metric sits in
a file of its own that is found by name, so a new cell, configuration or
metric is added by adding files and entries:

- ``configs/<config>.json``: the configuration as run; its ``family``
  names ``builders/<family>.py`` (the program's side) and
  ``reference/<family>.py`` (the plain reference);
- ``mixes/<traffic>.json``: the mode (``train`` or ``infer``), the trace
  length and any overrides of the configuration's graph;
- ``limits/<workload>.json``: the limit of each number compared;
- ``metrics/<name>.py``, else ``metrics/<name before the first dot>.py``:
  the reader of a per-layer metric, ``read(ctx)``.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import os
import re

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")
MODES = ("train", "infer")


class SpecError(ValueError):
    """A file of the benchmark breaks its rules or names nothing."""


def is_name(s) -> bool:
    return isinstance(s, str) and NAME.fullmatch(s) is not None


def is_unit(s) -> bool:
    return isinstance(s, str) and UNIT.fullmatch(s) is not None


def read_json(path: str):
    with open(path) as f:
        return json.load(f)


def load_spec(root: str = ROOT) -> dict:
    path = os.path.join(root, "BENCHMARK.json")
    if not os.path.exists(path):
        raise SpecError(f"no BENCHMARK.json at {root}")
    spec = read_json(path)
    check_names(spec)
    return spec


def check_names(spec: dict) -> None:
    """The rules on names and units: every ``name``, ``config``,
    ``traffic`` and ``reduced`` key, and every ``unit``; no two metrics,
    cells or configurations share a name."""
    seen = {}
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in spec.get(group, []):
            if not is_name(entry.get("name")):
                raise SpecError(f"{group}: bad name {entry.get('name')!r}")
            kind = "metric" if group in ("end_to_end", "per_layer") else group
            key = (kind, entry["name"])
            if key in seen:
                raise SpecError(f"{kind} {entry['name']!r} named twice")
            seen[key] = True
            if "unit" in entry and not is_unit(entry["unit"]):
                raise SpecError(f"{entry['name']}: bad unit {entry['unit']!r}")
            for k in ("config", "traffic"):
                if k in entry and not is_name(entry[k]):
                    raise SpecError(f"{entry['name']}: bad {k} {entry[k]!r}")
            for k in entry.get("reduced", []):
                if not is_name(k):
                    raise SpecError(f"{entry['name']}: bad reduced key {k!r}")


def _metrics_of(spec: dict, group: str, workload: str) -> list:
    return [m for m in spec.get(group, [])
            if workload in m.get("workloads", [workload])]


def resolve(spec: dict, workload: str, root: str = ROOT) -> dict:
    """The cell ``workload`` with every file it names loaded: its entry,
    the configuration (``cfg``), the mix, the limits, and its end-to-end
    and per-layer metrics."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SpecError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    configs = {c["name"]: c for c in spec["configs"]}
    if cell["config"] not in configs:
        raise SpecError(f"{workload}: no configuration {cell['config']!r}")
    centry = configs[cell["config"]]
    cfg = read_json(os.path.join(root, centry["file"]))
    base = os.path.join(root, "portbench")
    mix = read_json(os.path.join(base, "mixes", cell["traffic"] + ".json"))
    if mix.get("mode") not in MODES:
        raise SpecError(f"mix {cell['traffic']}: mode must be one of {MODES}")
    limits = read_json(os.path.join(base, "limits", workload + ".json"))
    return {"workload": cell, "config": centry, "cfg": cfg, "mix": mix,
            "limits": limits,
            "end_to_end": _metrics_of(spec, "end_to_end", workload),
            "per_layer": _metrics_of(spec, "per_layer", workload)}


def graph_spec(resolved: dict) -> dict:
    """The configuration's graph with the mix's overrides."""
    return {**resolved["cfg"]["graph"], **resolved["mix"].get("graph", {})}


def builder(family: str):
    """The program's side of a family: ``builders/<family>.py``."""
    return importlib.import_module(f"portbench.builders.{family}")


def reference(family: str):
    """The plain reference of a family: ``reference/<family>.py``."""
    return importlib.import_module(f"portbench.reference.{family}")


def metric_reader(name: str, root: str = ROOT):
    """The reader of per-layer metric ``name``: ``metrics/<name>.py``, else
    ``metrics/<name up to its first dot>.py``. Loaded from its path, since
    a metric's name may hold dots."""
    for stem in (name, name.split(".")[0]):
        path = os.path.join(root, "portbench", "metrics", stem + ".py")
        if os.path.exists(path):
            mod_name = "portbench_metric_" + re.sub(r"\W", "_", stem)
            loader = importlib.util.spec_from_file_location(mod_name, path)
            mod = importlib.util.module_from_spec(loader)
            loader.loader.exec_module(mod)
            return mod
    raise SpecError(f"no reader for per-layer metric {name!r}")
