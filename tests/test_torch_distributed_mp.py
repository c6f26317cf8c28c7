"""The port's distributed layer across processes: the seven phases of
``dryrun_multichip`` (``tests/dist_mp_phases.py``, at the
``DGL_TPU_DRYRUN_SMALL`` shapes) in 4 gloo processes started with
``torch.multiprocessing`` on 127.0.0.1, each joining through
``distributed.initialize``, held against the same phases on a one-process
mesh of 4 parts in this process: each rank's part of a sharded result
against that part, replicated results (losses, updated weights, byte
counts) against the one process's, at rtol 1e-5, atol 1e-5 * max|ref|.

The counterpart of ``tests/test_multiprocess.py``/``mc_worker.py`` (marked
slow). It imports no JAX. The workers are joined with a time limit of
their own, so a hung worker fails this test, is killed, and does not
stall the suite.
"""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import dgl_tpu_torch.parallel as tpar

import dist_mp_phases

WORLD = 4
LIMIT_S = 60.0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _close(got, ref, what):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=1e-5 * max(np.abs(ref).max(), 1e-30),
                               err_msg=what)


@pytest.fixture(scope="module")
def one_process():
    return dist_mp_phases.run_phases(
        tpar.create_mesh((WORLD,), ("gp",), device="cpu"),
        tpar.create_mesh((2, WORLD // 2), ("dp", "tp"), devices=WORLD,
                         device="cpu"))


def test_one_process_byte_audit(one_process):
    """The flagship path's exchanged integer bytes equal the analytic
    count (dryrun phase 7 allows 5 %)."""
    r = one_process
    assert int(r["p7_int_bytes"]) == int(r["p7_analytic_int_bytes"])
    assert int(r["p7_float_bytes"]) > 0


def test_seven_phases_over_four_gloo_processes(tmp_path, one_process):
    ctx = mp.start_processes(
        dist_mp_phases.worker, args=(WORLD, _free_port(), str(tmp_path)),
        nprocs=WORLD, join=False, start_method="spawn")
    import time

    deadline = time.monotonic() + LIMIT_S
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
            if time.monotonic() > deadline:
                pytest.fail(f"the gloo workers ran past {LIMIT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    ref = one_process
    for rank in range(WORLD):
        got = dict(np.load(tmp_path / f"rank{rank}.npz"))
        assert set(got) == set(ref), rank
        for k, v in ref.items():
            _close(got[k][0] if k.startswith("part:") else got[k],
                   v[rank] if k.startswith("part:") else v, f"{k} rank {rank}")


_LAUNCHED = """
import sys, torch, torch.distributed as dist
import dgl_tpu_torch.distributed as td
td.initialize(device="cpu")  # reads what tools/launch.py set
t = torch.tensor([float(td.get_rank() + 1)])
dist.all_reduce(t)
# one write a line: the workers share the launcher's stdout, and an
# unbuffered print writes each piece on its own
sys.stdout.write(f"{td.get_rank()} {td.get_world_size()} {float(t)}\\n")
sys.stdout.flush()
td.exit_client()
"""


def test_launch_py_starts_workers_that_initialize_reads():
    """``tools/launch.py`` starts 2 processes with the coordinator, count
    and rank in the environment; ``initialize`` joins them in one gloo
    group (rank r of 2; an all_reduce of r + 1 gives 3 on both)."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    proc = subprocess.run(
        [sys.executable, os.path.join(root, "tools", "launch.py"),
         "--num-procs", "2", "--coordinator", f"127.0.0.1:{_free_port()}",
         "--", sys.executable, "-c", _LAUNCHED],
        cwd=root, env=env, capture_output=True, text=True, timeout=LIMIT_S)
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = sorted(line for line in proc.stdout.splitlines() if line.strip())
    assert lines == ["0 2 3.0", "1 2 3.0"], proc.stdout
