"""BENCHMARK.json and the files it names: the contract's shape, the rules
on names and units, every cell resolved by name, and a cell added by data
files alone."""
import json
import os
import shutil

import pytest

from portbench import harness, spec
from portbench.tests.conftest import tiny

TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}
ENTRY = {"configs": {"name", "source", "file", "reduced", "why"},
         "workloads": {"name", "config", "traffic", "chips", "why"},
         "end_to_end": {"name", "unit", "better", "bound", "source"},
         "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_benchmark_json_shape():
    s = spec.load_spec()
    assert set(s) == TOP
    assert s["command"] == ["python3", "portbench/run.py"]
    assert s["paths"] == ["portbench"]
    assert isinstance(s["run_seconds"], int) and 1 <= s["run_seconds"] <= 51
    for group, keys in ENTRY.items():
        for e in s[group]:
            extra = set(e) - keys
            assert extra <= {"workloads"} and keys <= set(e), (group, e)
            if "source" in keys and group != "configs":
                assert e["source"] in SOURCES
            if "better" in e:
                assert e["better"] in ("lower", "higher")
    for m in s["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert len(json.dumps(s)) < 64 * 1024


def test_names_and_units():
    s = spec.load_spec()
    spec.check_names(s)
    for group in ("end_to_end", "per_layer"):
        for m in s[group]:
            assert spec.is_unit(m["unit"])


@pytest.mark.parametrize("bad", ["a b", "a/b", "", "x" * 65, ".a", "a,b",
                                 "µs"])
def test_bad_names_refused(bad):
    assert not spec.is_name(bad)
    with pytest.raises(spec.SpecError):
        spec.check_names({"workloads": [{"name": bad}]})


@pytest.mark.parametrize("bad", ["tokens per s", "µs", "", "x" * 17])
def test_bad_units_refused(bad):
    assert not spec.is_unit(bad)


def test_each_cell_resolves_and_reports():
    s = spec.load_spec()
    layers = {}
    for name in [w["name"] for w in s["workloads"]]:
        r = spec.resolve(s, name)
        e2e = {m["name"] for m in r["end_to_end"]}
        assert "setup_s" in e2e and len(e2e) >= 2, name
        assert r["per_layer"], name
        for m in r["per_layer"]:
            assert m["moves"] in e2e, (name, m["name"])
            assert callable(spec.metric_reader(m["name"]).read)
            layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
        assert os.path.exists(os.path.join(spec.ROOT, r["config"]["file"]))
        assert spec.builder(r["cfg"]["family"]).build
        assert spec.reference(r["cfg"]["family"]).forward
        assert set(r["limits"]) == ({"first_loss_gap", "grad_gap",
                                     "median_change_gap", "window_loss_gap",
                                     "window_grad_gap", "window_change_gap",
                                     "dropout_replay"}
                                    if r["mix"]["mode"] == "train"
                                    else {"logits_median_row_gap",
                                          "logits_worst_row_gap"})
    # a quantity's metrics name one layer, letter for letter
    assert all(len(v) == 1 for v in layers.values()), layers


def test_dropped_in_cell_is_found_and_runs(tmp_path):
    """A new configuration, mix and limits, added as files and entries
    only, resolve by name and run (at a CPU size)."""
    root = tmp_path
    shutil.copytree(os.path.join(spec.ROOT, "portbench"),
                    root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    s = spec.load_spec()
    cfg = spec.read_json(os.path.join(spec.ROOT, "portbench", "configs",
                                      "sage_arxiv.json"))
    cfg["hidden_channels"] = 64
    (root / "portbench" / "configs" / "sage_dummy.json").write_text(
        json.dumps(cfg))
    (root / "portbench" / "mixes" / "train_dummy.json").write_text(
        json.dumps({"mode": "train", "trace_steps": 2}))
    (root / "portbench" / "limits" / "sage_dummy.train_dummy.json"
     ).write_text(json.dumps({"first_loss_gap": 1e-4, "grad_gap": 1e-4,
                              "median_change_gap": 1e-4,
                              "window_loss_gap": 1e-4,
                              "window_grad_gap": 1e-4,
                              "window_change_gap": 1e-4,
                              "dropout_replay": 0}))
    s["configs"].append({"name": "sage_dummy", "source": "x",
                         "file": "portbench/configs/sage_dummy.json",
                         "reduced": [], "why": "a test"})
    s["workloads"].append({"name": "sage_dummy.train_dummy",
                           "config": "sage_dummy", "traffic": "train_dummy",
                           "chips": 1, "why": "a test"})
    for m in s["end_to_end"] + s["per_layer"]:
        if "sage_arxiv.train" in m.get("workloads", []):
            m["workloads"].append("sage_dummy.train_dummy")
    (root / "BENCHMARK.json").write_text(json.dumps(s))
    r = spec.resolve(spec.load_spec(str(root)), "sage_dummy.train_dummy",
                     str(root))
    assert r["cfg"]["hidden_channels"] == 64
    assert {m["name"] for m in r["end_to_end"]} == {"train_step_ms",
                                                    "setup_s"}
    res = harness.run_cell(tiny(r), 3_000_000_007, 0.2, False, "cpu")
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {"train_step_ms", "setup_s"}
