"""The port's bitmap SpMM (kernel B2's module) against ``dgl_tpu``.

- Plans: the port builds the bitmap with one ``index_add_`` on the
  indices' device; its bytes must equal the reference's ``_pack_host`` bit
  for bit, on asymmetric and symmetric relations, and both refuse
  multi-edges and plans over budget.
- ``bitmap_copy_u_sum``: both sides multiply the 0/1 matrix by ``x``
  rounded to bf16 and sum in f32 on the CPU, in different orders:
  rtol = atol = 1e-5.
- ``gspmm`` dispatch and the ``"auto"`` gate of ``with_spmm_plans``: the
  same plans attach on both sides; the bitmap path against the exact f32
  path at the bf16 bound rtol = 2e-2, atol = 2e-2 * max|ref| (the
  reference's ``test_forward_bf16_error_bound`` class).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import dgl_tpu
from dgl_tpu.ops import bitmap_spmm as jb
import dgl_tpu_torch as dt
from dgl_tpu_torch import _kernels
from dgl_tpu_torch.ops import bitmap_spmm as tb


def _simple_edges(n_src, n_dst, e, seed, symmetric=False):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_src, e)
    dst = rng.integers(0, n_dst, e)
    if symmetric:
        src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
    flat = np.unique(dst.astype(np.int64) * n_src + src)  # dedup
    return (flat % n_src).astype(np.int64), (flat // n_src).astype(np.int64)


def _relations(src, dst, n_src, n_dst):
    jrel = dgl_tpu.heterograph({("u", "e", "v"): (src, dst)},
                               {"u": n_src, "v": n_dst})._relation(None)
    trel = dt.Relation.from_coo(src, dst, n_src, n_dst, device="cpu")
    return jrel, trel


@pytest.mark.parametrize("n_src,n_dst,e,symmetric", [
    (5000, 700, 40000, False),   # asymmetric: two bitmaps, ragged tiles
    (4100, 4100, 30000, True),   # symmetric square: bits serves both ways
    (513, 4097, 9000, False),    # one column past a tile, rows past 4096
])
def test_plan_bytes_match_reference(n_src, n_dst, e, symmetric):
    src, dst = _simple_edges(n_src, n_dst, e, 1, symmetric)
    jrel, trel = _relations(src, dst, n_src, n_dst)
    jp, tp = jb.build_bitmap_plan(jrel), tb.build_bitmap_plan(trel)
    assert tp.bits.dtype == torch.uint8
    np.testing.assert_array_equal(np.asarray(jp.bits), tp.bits.numpy())
    assert (jp.bits_rev is None) == (tp.bits_rev is None) == symmetric
    if not symmetric:
        np.testing.assert_array_equal(np.asarray(jp.bits_rev),
                                      tp.bits_rev.numpy())
    dense = tb.unpack_host(tp.bits.numpy())
    assert dense.sum() == src.size
    assert dense[dst, src].all()
    assert tb.bitmap_bytes(n_src, n_dst, symmetric) == tp.bits.numel() + (
        0 if symmetric else tp.bits_rev.numel())


def test_refuses_multiedges_and_budget():
    multi = dt.Relation.from_coo(np.array([0, 0, 1]), np.array([1, 1, 2]),
                                 3, 3, device="cpu")
    assert tb.build_bitmap_plan(multi) is None
    src, dst = _simple_edges(300, 200, 4000, 0)
    jrel, trel = _relations(src, dst, 300, 200)
    assert jb.build_bitmap_plan(jrel, max_bytes=10) is None
    assert tb.build_bitmap_plan(trel, max_bytes=10) is None
    assert tb.bitmap_bytes(300, 200, False) == jb.bitmap_bytes(300, 200,
                                                               False)
    # the exact mode builds the same bits and records its type; any other
    # type raises
    plan = tb.build_bitmap_plan(trel)
    plan32 = tb.build_bitmap_plan(trel, compute_dtype="float32")
    assert plan32.compute_dtype == "float32"
    assert torch.equal(plan32.bits, plan.bits)
    assert torch.equal(plan32.bits_rev, plan.bits_rev)
    with pytest.raises(ValueError, match="float16"):
        tb.build_bitmap_plan(trel, compute_dtype="float16")


@pytest.mark.parametrize("feat", [16, 41, 130])
def test_bitmap_copy_u_sum_matches(feat):
    n_src, n_dst = 4200, 900
    src, dst = _simple_edges(n_src, n_dst, 60000, 2)
    jrel, trel = _relations(src, dst, n_src, n_dst)
    jp, tp = jb.build_bitmap_plan(jrel), tb.build_bitmap_plan(trel)
    x = np.random.default_rng(3).normal(size=(n_src, feat)).astype(np.float32)
    ref = np.asarray(jb.bitmap_copy_u_sum(jp, jnp.asarray(x)))
    _kernels.reset_launch_counts()
    out = tb.bitmap_copy_u_sum(tp, torch.from_numpy(x))
    assert _kernels.launch_counts["bitmap_spmm"] == 0  # CPU: plain version
    assert out.shape == (n_dst, feat) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)
    # the plain version on a subset of rows, as the kernel check uses it
    part = tb.bitmap_matmul_plain(tp.bits[100:300], torch.from_numpy(x))
    np.testing.assert_allclose(part.numpy(), ref[100:300], rtol=1e-5,
                               atol=1e-5)


def test_gspmm_dispatch_and_auto_gate():
    n = 600
    src, dst = _simple_edges(n, n, 30000, 7)  # density ~8e-2
    jg = dgl_tpu.graph((src, dst), num_nodes=n)
    tg = dt.graph((src, dst), num_nodes=n, device="cpu")
    jgp = jg.with_spmm_plans(num_hubs=16)
    tgp = tg.with_spmm_plans(num_hubs=16)
    assert jgp._relation().bitmap_plan is not None
    tplan = tgp._relation().bitmap_plan
    assert tplan is not None and tgp._relation().hub_plan is not None
    np.testing.assert_array_equal(
        np.asarray(jgp._relation().bitmap_plan.bits), tplan.bits.numpy())
    # 360,000 cells <= 16M, no multi-edges: both attach the dense mask
    assert jgp._relation().dense_adj is not None
    np.testing.assert_array_equal(tgp._relation().dense_adj.mask.numpy(),
                                  np.asarray(jgp._relation().dense_adj.mask))
    x = np.random.default_rng(8).normal(size=(n, 12)).astype(np.float32)
    xt = torch.from_numpy(x)
    for op in ("copy_u_sum", "copy_u_mean"):
        ref = np.asarray(getattr(dgl_tpu.ops, op)(jgp, jnp.asarray(x)))
        _kernels.reset_launch_counts()
        out = getattr(dt.ops, op)(tgp, xt).numpy()
        np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
        exact = getattr(dt.ops, op)(tg, xt).numpy()
        scale = np.abs(exact).max()
        np.testing.assert_allclose(out, exact, rtol=2e-2, atol=2e-2 * scale)
        assert not np.array_equal(out, exact)  # bf16 rows: not the f32 path
    # 3-D features fall through to the hub path on both sides
    x3 = np.random.default_rng(9).normal(size=(n, 2, 6)).astype(np.float32)
    ref3 = np.asarray(dgl_tpu.ops.copy_u_sum(jgp, jnp.asarray(x3)))
    out3 = dt.ops.copy_u_sum(tgp, torch.from_numpy(x3)).numpy()
    np.testing.assert_allclose(out3, ref3, rtol=1e-4, atol=1e-4)
    # the plan moves with the relation
    moved = tgp._relation().to("cpu")
    assert moved.bitmap_plan is not tplan
    assert torch.equal(moved.bitmap_plan.bits, tplan.bits)


def test_auto_gate_skips_sparse_graphs_and_forces():
    n = 5000
    src, dst = _simple_edges(n, n, 3000, 9)  # density ~1.2e-4
    jg = dgl_tpu.graph((src, dst), num_nodes=n)
    tg = dt.graph((src, dst), num_nodes=n, device="cpu")
    jrel = jg.with_spmm_plans(num_hubs=16)._relation()
    assert jrel.bitmap_plan is None and jrel.dense_adj is None
    rel = tg.with_spmm_plans(num_hubs=16)._relation()
    assert rel.bitmap_plan is None and rel.dense_adj is None  # 25M cells
    # ... but 25M cells are within a larger dense-attention budget
    jrel = jg.with_spmm_plans(num_hubs=16, dense_attn_max_cells=3 * 10**7)
    trel = tg.with_spmm_plans(num_hubs=16, dense_attn_max_cells=3 * 10**7)
    assert jrel._relation().dense_adj is not None
    np.testing.assert_array_equal(
        trel._relation().dense_adj.mask.numpy(),
        np.asarray(jrel._relation().dense_adj.mask))
    assert tg.with_spmm_plans(num_hubs=16, dense_attn=False,
                              dense_attn_max_cells=3 * 10**7
                              )._relation().dense_adj is None
    # bitmap=True forces the plan whatever the density
    forced = tg.with_spmm_plans(num_hubs=16, bitmap=True)._relation()
    jforced = jg.with_spmm_plans(num_hubs=16, bitmap=True)._relation()
    np.testing.assert_array_equal(np.asarray(jforced.bitmap_plan.bits),
                                  forced.bitmap_plan.bits.numpy())


def test_backward_raises():
    """The backward that raised before training was ported: ``A^T dz``
    through B2's module over ``bits_rev`` (asymmetric relation), held
    against the plain matmul over the transpose at rtol = atol = 1e-5 and
    against the exact f32 path's gradient at the bf16 bound."""
    n = 300
    src, dst = _simple_edges(n, n, 9000, 11)
    g = dt.graph((src, dst), num_nodes=n, device="cpu").with_spmm_plans(
        num_hubs=16, bitmap=True)
    plan = g._relation().bitmap_plan
    assert plan is not None and plan.bits_rev is not None
    x = torch.randn(n, 8, requires_grad=True)
    dz = torch.randn(n, 8)
    _kernels.reset_launch_counts()
    (dt.ops.copy_u_sum(g, x) * dz).sum().backward()
    assert _kernels.launch_counts["bitmap_spmm"] == 0  # CPU: plain version
    want = tb.bitmap_matmul_plain(plan.bits_rev, dz, n)
    torch.testing.assert_close(x.grad, want, rtol=1e-5, atol=1e-5)
    x_ref = x.detach().clone().requires_grad_()
    g_ref = dt.graph((src, dst), num_nodes=n, device="cpu")
    (dt.ops.copy_u_sum(g_ref, x_ref) * dz).sum().backward()
    scale = x_ref.grad.abs().max().item()
    torch.testing.assert_close(x.grad, x_ref.grad, rtol=2e-2,
                               atol=2e-2 * scale)
