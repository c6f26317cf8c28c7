"""The run's guards: no JAX module in a run's process (whole top-level
names), no result without a card, none outside a checkout."""
import os
import shutil
import subprocess
import sys

import pytest

from portbench import spec
from portbench.run import forbidden_modules


@pytest.mark.parametrize("mods,found", [
    (["dgl_tpu_torch", "dgl_tpu_torch.ops.hub_spmm", "torch"], []),
    (["dgl_tpu", "dgl_tpu_torch"], ["dgl_tpu"]),
    (["dgl_tpu.ops.spmm"], ["dgl_tpu"]),
    (["jax.numpy", "jaxlib.xla_client"], ["jax", "jaxlib"]),
    (["flax.linen"], ["flax"]),
    (["jaxtyping", "flaxen", "dgl_tpux", "mydgl_tpu"], []),
])
def test_forbidden_modules_by_whole_top_level_name(mods, found):
    assert forbidden_modules(mods) == found


def _run(args, cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "portbench/run.py", *args],
                          cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=300)


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is here")
    p = _run(["--workload", "sage_arxiv.train", "--seed", "1",
              "--seconds", "1", "--trace", "0"], spec.ROOT)
    assert p.returncode != 0 and p.stdout == "", (p.returncode, p.stdout)
    assert "CUDA" in p.stderr


def test_outside_a_checkout_no_result(tmp_path):
    """With only BENCHMARK.json and the benchmark's files, a run fails
    before any result: the program is not there."""
    shutil.copy(os.path.join(spec.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(spec.ROOT, "portbench"),
                    tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys; sys.path.insert(0, '.'); "
            "from portbench import spec, harness; "
            "from portbench.tests.conftest import tiny; "
            "r = tiny(spec.resolve(spec.load_spec('.'), 'sage_arxiv.train',"
            " '.')); harness.run_cell(r, 1, 0.1, False, 'cpu')")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout == ""
    assert "dgl_tpu_torch" in p.stderr
    p = _run(["--workload", "sage_arxiv.train", "--seed", "1",
              "--seconds", "1", "--trace", "0"], tmp_path)
    assert p.returncode != 0 and p.stdout == ""


def test_a_run_loads_no_jax():
    """A whole run (at a CPU size) in a fresh process loads none of
    jax, jaxlib, flax and dgl_tpu."""
    code = ("import sys; sys.path.insert(0, '.'); "
            "from portbench import harness; "
            "from portbench.tests.conftest import tiny_cell; "
            "from portbench.run import forbidden_modules; "
            "harness.run_cell(tiny_cell('rgcn_mag.train'), 5, 0.1, False, "
            "'cpu'); print(forbidden_modules())")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == "[]"
