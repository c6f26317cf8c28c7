"""Parity of the port's shell prefix sum and hub SpMM with ``dgl_tpu``.

- The plain PyTorch version of the shell prefix sum against the Pallas
  kernel ``shell_prefix_sum_pallas`` run in interpret mode (f32 sums of the
  same bf16 rows in the same order: rtol = atol = 1e-5).
- The hub plan's arrays, exact.
- ``hub_copy_u_sum`` against the reference at 1e-4, and against exact f32
  ``copy_u_sum`` at 2e-2 (bf16-rounded rows).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import dgl_tpu
import dgl_tpu.ops.shell_pallas as sp
import dgl_tpu.ops.shell_spmm as jss
from dgl_tpu.ops.hub_spmm import build_hub_plan as j_build_hub_plan
from dgl_tpu.ops.hub_spmm import hub_copy_u_sum as j_hub_copy_u_sum
import dgl_tpu_torch as dt
from dgl_tpu_torch import _kernels
from dgl_tpu_torch.ops import shell_spmm as tss
from dgl_tpu_torch.ops.hub_spmm import build_hub_plan, hub_copy_u_sum
from dgl_tpu_torch.ops.shell_prefix import (
    flat_shell_indices, shell_prefix_sum, shell_prefix_sum_plain)

LEVELS = [1500, 1104, 600, 17, 8]  # non-increasing, as the shells are
N_TABLE = 2000


def _shell_inputs(feat, seed):
    """bf16 table, per-level indices with some out-of-range (zero) slots,
    and an f32 base."""
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(N_TABLE, feat)).astype(np.float32)
    table_bf = torch.from_numpy(table).to(torch.bfloat16)
    idx = [rng.integers(0, N_TABLE + 1, m).astype(np.int32) for m in LEVELS]
    base = rng.normal(size=(LEVELS[0] + 8, feat)).astype(np.float32)
    return table_bf, idx, base


@pytest.mark.parametrize("with_base", [False, True])
@pytest.mark.parametrize("feat", [40, 128, 256])
def test_plain_matches_pallas_interpret(feat, with_base):
    table_bf, idx, base = _shell_inputs(feat, feat + int(with_base))
    n_out = LEVELS[0] + 5  # rows past every level read the base (or 0)
    flat_t, rows_t = flat_shell_indices(
        [torch.from_numpy(i) for i in idx], n_out, oob_index=N_TABLE)
    flat_j, rows_j = sp.flat_shell_indices(
        [jnp.asarray(i) for i in idx], n_out, oob_index=N_TABLE)
    assert rows_t == rows_j
    np.testing.assert_array_equal(flat_t.numpy(), np.asarray(flat_j))
    # the reference gathers with jnp.take(mode="fill") before its kernel
    tab = table_bf.to(torch.float32).numpy()
    tab0 = np.concatenate([tab, np.zeros((1, feat), np.float32)])
    pieces = jnp.asarray(tab0[np.asarray(flat_j)], jnp.bfloat16)
    b = base if with_base else None
    sp._FORCE_PALLAS_INTERPRET = True
    try:
        ref = sp.shell_prefix_sum_pallas(
            pieces, rows_j, n_out, base=None if b is None else jnp.asarray(b))
    finally:
        sp._FORCE_PALLAS_INTERPRET = False
    out = shell_prefix_sum(table_bf, flat_t, rows_t, n_out,
                           base=None if b is None else torch.from_numpy(b))
    assert out.dtype == torch.float32 and tuple(out.shape) == (n_out, feat)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref)[:n_out],
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("with_base", [False, True])
def test_prefix_and_residual_reduce_match(with_base):
    rng = np.random.default_rng(11)
    n8 = 40
    pieces = [rng.normal(size=(m, 3)).astype(np.float32) for m in (40, 24, 8)]
    b = rng.normal(size=(n8, 3)).astype(np.float32) if with_base else None
    ref = jss.prefix_reduce([jnp.asarray(p) for p in pieces], n8, "sum",
                            None if b is None else jnp.asarray(b))
    out = tss.prefix_reduce([torch.from_numpy(p) for p in pieces], n8,
                            None if b is None else torch.from_numpy(b))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6)
    block_pos = np.array([0, 0, 3, 5, 5, 5], np.int32)
    rows = rng.normal(size=(6 * jss.RES_BLOCK, 3)).astype(np.float32)
    res_j = (None, None, None, jnp.asarray(block_pos))
    res_t = (None, None, None, torch.from_numpy(block_pos))
    ref = jss.residual_reduce(jnp.asarray(rows), res_j, 8, "sum")
    out = tss.residual_reduce(torch.from_numpy(rows), res_t, 8)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5)


def _skewed_graph(n, e, seed, dst_skew=False):
    """zipf sources; with ``dst_skew`` some destinations pass the shell cap
    of 32 in-edges, so the plan has a residual."""
    rng = np.random.default_rng(seed)
    w = 1.0 / np.arange(1, n + 1)
    src = rng.choice(n, e, p=w / w.sum())
    dst = (rng.choice(n, e, p=(w ** 0.7) / (w ** 0.7).sum()) if dst_skew
           else rng.integers(0, n, e))
    return src, dst


def _t(x):
    return None if x is None else x.numpy()


@pytest.mark.parametrize("dst_skew,num_hubs", [(False, 128), (True, 256)])
def test_hub_plan_arrays_exact(dst_skew, num_hubs):
    n, e = 4000, 30000
    src, dst = _skewed_graph(n, e, 21, dst_skew)
    jrel = dgl_tpu.graph((src, dst), num_nodes=n)._relation()
    trel = dt.graph((src, dst), num_nodes=n, device="cpu")._relation()
    jp = j_build_hub_plan(jrel, num_hubs, "int8")
    tp = build_hub_plan(trel, num_hubs, "int8")
    assert (tp.num_hubs, tp.precision) == (jp.num_hubs, jp.precision)
    assert jp.cold == "shell"
    assert tp.coverage == jp.coverage
    np.testing.assert_array_equal(tp.hub_ids.numpy(), np.asarray(jp.hub_ids))
    assert tp.a_hub.dtype == torch.int8
    np.testing.assert_array_equal(tp.a_hub.numpy(), np.asarray(jp.a_hub))
    assert len(tp.shells) == len(jp.shells)
    for (ti, tm), (ji, jm) in zip(tp.shells, jp.shells):
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert (tp.res_dst is None) == (jp.res_dst is None)
    assert (tp.res_dst is not None) == dst_skew
    if jp.res_dst is not None:
        for ta, ja in zip(tp.res_dst, jp.res_dst):
            np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(_t(tp.unrank_dst), np.asarray(jp.unrank_dst))
    # the backward's reverse shells (cold edges ranked by source)
    assert len(tp.rev_shells) == len(jp.rev_shells) > 0
    for (ti, tm), (ji, jm) in zip(tp.rev_shells, jp.rev_shells):
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert (tp.res_src is None) == (jp.res_src is None)
    if jp.res_src is not None:
        for ta, ja in zip(tp.res_src, jp.res_src):
            np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    assert (tp.unrank_src is None) == (jp.unrank_src is None)
    if jp.unrank_src is not None:
        np.testing.assert_array_equal(tp.unrank_src.numpy(),
                                      np.asarray(jp.unrank_src))


def test_hub_plan_int8_falls_back_to_bf16():
    """A (dst, hub) multiplicity above 127 does not fit int8 counts."""
    rng = np.random.default_rng(5)
    n = 300
    src = np.concatenate([np.zeros(200, np.int64), rng.integers(0, n, 900)])
    dst = np.concatenate([np.ones(200, np.int64), rng.integers(0, n, 900)])
    jp = j_build_hub_plan(dgl_tpu.graph((src, dst), num_nodes=n)._relation(),
                          128, "int8")
    tp = build_hub_plan(dt.graph((src, dst), num_nodes=n,
                                 device="cpu")._relation(), 128, "int8")
    assert jp.precision == tp.precision == "bf16"
    assert tp.a_hub.dtype == torch.bfloat16
    np.testing.assert_array_equal(tp.a_hub.to(torch.float32).numpy(),
                                  np.asarray(jp.a_hub, np.float32))


@pytest.mark.parametrize("dst_skew,reorder,feat", [(False, True, 64),
                                                   (True, False, 24)])
def test_hub_copy_u_sum_matches(dst_skew, reorder, feat):
    n, e = 6000, 48000
    src, dst = _skewed_graph(n, e, 31, dst_skew)
    jg = dgl_tpu.graph((src, dst), num_nodes=n)
    tg = dt.graph((src, dst), num_nodes=n, device="cpu")
    if reorder:
        jg, jperm = dgl_tpu.transforms.reorder_for_spmm(jg, num_hubs=256)
        tg, tperm = dt.transforms.reorder_for_spmm(tg, num_hubs=256)
        np.testing.assert_array_equal(jperm, tperm)
        jplan, tplan = jg._relation().hub_plan, tg._relation().hub_plan
    else:  # unreordered: exercises the unrank gather and the residual base
        jplan = j_build_hub_plan(jg._relation(), 256, "int8")
        tplan = build_hub_plan(tg._relation(), 256, "int8")
        assert tplan.unrank_dst is not None and tplan.res_dst is not None
    assert jg._relation().bitmap_plan is None
    x = np.random.default_rng(32).normal(size=(n, feat)).astype(np.float32)
    ref = np.asarray(j_hub_copy_u_sum(jplan, jnp.asarray(x)))
    out = hub_copy_u_sum(tplan, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)
    exact = np.asarray(dgl_tpu.ops.copy_u_sum(
        dgl_tpu.graph((np.asarray(jg._relation().src),
                       np.asarray(jg._relation().dst)), num_nodes=n),
        jnp.asarray(x)))
    scale = np.abs(exact).max()
    np.testing.assert_allclose(out, exact, rtol=2e-2, atol=2e-2 * scale)


def test_hub_backward_raises():
    """The backward that raised before training was ported: ``A_hub^T dz``
    plus the reverse shells through B1's module, against the exact f32
    path's gradient at the bf16 bound rtol = 2e-2, atol = 2e-2 * max|ref|
    (``dz`` rounds to bf16 as the forward's rows do)."""
    src, dst = _skewed_graph(500, 3000, 1)
    g, _ = dt.transforms.reorder_for_spmm(
        dt.graph((src, dst), num_nodes=500, device="cpu"), num_hubs=128)
    plan = g._relation().hub_plan
    assert plan.rev_shell_rows and plan.unrank_src is not None
    x = torch.randn(500, 8, requires_grad=True)
    dz = torch.randn(500, 8)
    _kernels.reset_launch_counts()
    (dt.ops.copy_u_sum(g, x) * dz).sum().backward()
    assert _kernels.launch_counts["shell_prefix_sum"] == 0  # CPU: plain
    rel = g._relation()
    x_ref = x.detach().clone().requires_grad_()
    g_ref = dt.graph((rel.src.numpy(), rel.dst.numpy()), num_nodes=500,
                     device="cpu")
    (dt.ops.copy_u_sum(g_ref, x_ref) * dz).sum().backward()
    scale = x_ref.grad.abs().max().item()
    torch.testing.assert_close(x.grad, x_ref.grad, rtol=2e-2,
                               atol=2e-2 * scale)


def test_cpu_path_launches_no_kernel():
    _kernels.reset_launch_counts()
    table_bf, idx, _ = _shell_inputs(40, 0)
    flat, rows = flat_shell_indices([torch.from_numpy(i) for i in idx],
                                    LEVELS[0], oob_index=N_TABLE)
    shell_prefix_sum(table_bf, flat, rows, LEVELS[0])
    assert _kernels.launch_counts["shell_prefix_sum"] == 0
