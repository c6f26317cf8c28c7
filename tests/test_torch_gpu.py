"""The port's CUDA kernels on the card, against their plain versions.

Every test here is marked ``gpu`` and skips where there is no CUDA card: a
CUDA kernel has no CPU mode. The file imports neither JAX nor the JAX
package, so it also runs on a machine that has only PyTorch:

    python -m pytest tests/test_torch_gpu.py --noconftest -m gpu -q

(``--noconftest`` skips ``tests/conftest.py``, which configures JAX.)
"""
import numpy as np
import pytest
import torch

import dgl_tpu_torch as dt
from dgl_tpu_torch import _kernels
from dgl_tpu_torch.nn import GATConv
from dgl_tpu_torch.ops import bitmap_gat as tbg
from dgl_tpu_torch.ops.bitmap_spmm import (
    bitmap_matmul, bitmap_matmul_plain, build_bitmap_plan)
from dgl_tpu_torch.ops.hub_spmm import build_hub_plan, hub_copy_u_sum
from dgl_tpu_torch.ops.shell_prefix import (
    flat_shell_indices, shell_prefix_sum, shell_prefix_sum_plain)

pytestmark = pytest.mark.gpu

LEVELS = [1500, 1104, 600, 17, 8]  # non-increasing, as the shells are
N_TABLE = 2000


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _shell_inputs(feat, seed):
    rng = np.random.default_rng(seed)
    table = torch.from_numpy(rng.normal(size=(N_TABLE, feat)).astype(
        np.float32)).to(torch.bfloat16)
    idx = [torch.from_numpy(rng.integers(0, N_TABLE + 1, m).astype(np.int32))
           for m in LEVELS]
    base = torch.from_numpy(rng.normal(size=(LEVELS[0] + 8, feat)).astype(
        np.float32))
    return table, idx, base


@pytest.mark.parametrize("n_out", [LEVELS[0] + 5, 1000])
@pytest.mark.parametrize("feat", [40, 128, 256, 13])
def test_kernel_matches_plain(card, feat, n_out):
    """Both sum the same f32 values in the same order: rtol = atol = 1e-5.
    F = 13 takes the scalar path; n_out = 1000 cuts the deeper levels."""
    table, idx, base = _shell_inputs(feat, 3)
    flat, rows = flat_shell_indices(idx, n_out, oob_index=N_TABLE)
    table_c, flat_c = table.to(card), flat.to(card)
    rows_b = base.shape[0] - 1
    # a contiguous view one element in: not 16-byte aligned, scalar path
    shifted = base.to(card).reshape(-1)[1:1 + rows_b * feat].view(rows_b, feat)
    for b in (None, base.to(card), shifted):
        before = _kernels.launch_counts["shell_prefix_sum"]
        out = shell_prefix_sum(table_c, flat_c, rows, n_out, base=b)
        torch.cuda.synchronize()
        assert _kernels.launch_counts["shell_prefix_sum"] == before + 1
        ref = shell_prefix_sum_plain(table_c, flat_c, rows, n_out, base=b)
        assert out.shape == (n_out, feat) and out.dtype == torch.float32
        torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
        cpu = shell_prefix_sum_plain(table, flat, rows, n_out,
                                     base=None if b is None else b.cpu())
        torch.testing.assert_close(out.cpu(), cpu, rtol=1e-5, atol=1e-5)


def test_kernel_rejects_wrong_inputs(card):
    table, idx, _ = _shell_inputs(40, 4)
    flat, rows = flat_shell_indices(idx, LEVELS[0], oob_index=N_TABLE)
    with pytest.raises(ValueError, match="bf16"):
        shell_prefix_sum(table.float().to(card), flat.to(card), rows,
                         LEVELS[0])
    with pytest.raises(ValueError, match="int32"):
        shell_prefix_sum(table.to(card), flat.long().to(card), rows,
                         LEVELS[0])
    with pytest.raises(ValueError, match="shorter"):
        shell_prefix_sum(table.to(card), flat[:100].to(card), rows,
                         LEVELS[0])


def test_hub_copy_u_sum_on_card_matches_cpu(card):
    """The whole hub SpMM on the card (bf16 tensor-core matmul with an f32
    result, the CUDA kernel) against the same plan on the CPU."""
    rng = np.random.default_rng(7)
    n, e = 6000, 48000
    w = 1.0 / np.arange(1, n + 1)
    src = rng.choice(n, e, p=w / w.sum())
    dst = rng.choice(n, e, p=(w ** 0.7) / (w ** 0.7).sum())  # a residual
    rel = dt.graph((src, dst), num_nodes=n, device="cpu")._relation()
    plan = build_hub_plan(rel, 256, "int8")
    assert plan.res_dst is not None and plan.unrank_dst is not None
    x = torch.from_numpy(rng.normal(size=(n, 64)).astype(np.float32))
    ref = hub_copy_u_sum(plan, x)
    before = _kernels.launch_counts["shell_prefix_sum"]
    out = hub_copy_u_sum(plan.to(card), x.to(card))
    torch.cuda.synchronize()
    assert _kernels.launch_counts["shell_prefix_sum"] == before + 1
    # same bf16 products and f32 sums, in another order on the card
    torch.testing.assert_close(out.cpu(), ref, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# B2 (bitmap_spmm) and B3 (bitmap_gat_fwd)
# ---------------------------------------------------------------------------

N_SRC, N_DST = 5000, 1300  # neither a multiple of 512 nor of 4096


def _bitmap_edges(seed):
    """Random edges, dst rows 1000..1099 left empty, and a full tile: dst
    rows 0..31 connected to every source 0..4095."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, N_SRC, 60000)
    dst = rng.integers(0, N_DST, 60000)
    keep = (dst < 1000) | (dst >= 1100)
    full_s, full_d = np.meshgrid(np.arange(4096), np.arange(32))
    src = np.concatenate([src[keep], full_s.ravel()])
    dst = np.concatenate([dst[keep], full_d.ravel()])
    flat = np.unique(dst.astype(np.int64) * N_SRC + src)
    return flat % N_SRC, flat // N_SRC


@pytest.fixture(scope="module")
def bitmap_plans():
    src, dst = _bitmap_edges(11)
    rel = dt.Relation.from_coo(src, dst, N_SRC, N_DST, device="cpu")
    plan = build_bitmap_plan(rel)
    return plan, np.bincount(dst, minlength=N_DST)


def test_bitmap_plan_built_on_card_equals_cpu(card, bitmap_plans):
    plan, _ = bitmap_plans
    src, dst = _bitmap_edges(11)
    rel = dt.Relation.from_coo(src, dst, N_SRC, N_DST, device=card)
    got = build_bitmap_plan(rel)
    assert torch.equal(got.bits.cpu(), plan.bits)
    assert torch.equal(got.bits_rev.cpu(), plan.bits_rev)


def _close(got, want, rtol):
    """rtol and atol = 1e-5 * max|want|: the same f32 terms summed in
    another order."""
    scale = max(want.abs().max().item(), 1e-30)
    torch.testing.assert_close(got, want, rtol=rtol, atol=1e-5 * scale)


@pytest.mark.parametrize("feat", [1, 16, 41, 130])
def test_bitmap_spmm_kernel_matches_plain(card, bitmap_plans, feat):
    plan, deg = bitmap_plans
    x = torch.from_numpy(np.random.default_rng(feat).normal(
        size=(N_SRC, feat)).astype(np.float32))
    bits = plan.bits.to(card)
    before = _kernels.launch_counts["bitmap_spmm"]
    out = bitmap_matmul(bits, x.to(card), N_DST)
    torch.cuda.synchronize()
    assert _kernels.launch_counts["bitmap_spmm"] == before + 1
    assert out.shape == (N_DST, feat) and out.dtype == torch.float32
    _close(out, bitmap_matmul_plain(bits, x.to(card), N_DST), 1e-5)
    _close(out.cpu(), bitmap_matmul_plain(plan.bits, x, N_DST), 1e-5)
    assert not out[torch.from_numpy(deg == 0).to(card)].any()
    # the transpose bitmap: a different row length and row count
    out_t = bitmap_matmul(plan.bits_rev.to(card),
                          torch.ones(N_DST, feat, device=card), N_SRC)
    want_t = torch.from_numpy(np.bincount(
        _bitmap_edges(11)[0], minlength=N_SRC).astype(np.float32))
    torch.testing.assert_close(out_t.cpu(), want_t[:, None].expand(-1, feat))


@pytest.mark.parametrize("heads,odim", [(8, 8), (1, 41), (3, 5), (2, 130)])
def test_bitmap_gat_kernel_matches_plain(card, bitmap_plans, heads, odim):
    """(3, 5) pads heads and features; (2, 130) runs three feature passes.
    rtol = 1e-4, atol = 1e-5 * max|ref|: the exponentials and sums run in
    another order (an online softmax merged across lanes)."""
    plan, deg = bitmap_plans
    rng = np.random.default_rng(heads * 1000 + odim)
    el = torch.from_numpy(rng.normal(size=(N_SRC, heads)).astype(np.float32))
    er = torch.from_numpy(rng.normal(size=(N_DST, heads)).astype(np.float32))
    h = torch.from_numpy(rng.normal(size=(N_SRC, heads, odim)).astype(
        np.float32)).to(torch.bfloat16)
    bits = plan.bits.to(card)
    before = _kernels.launch_counts["bitmap_gat_fwd"]
    out, lse = tbg.bitmap_gat_fwd(bits, el.to(card), er.to(card),
                                  h.to(card), 0.2, N_DST)
    torch.cuda.synchronize()
    assert _kernels.launch_counts["bitmap_gat_fwd"] == before + 1
    ref_out, ref_lse = tbg.gat_fwd_plain(bits[:N_DST], el.to(card),
                                         er.to(card), h.to(card), 0.2)
    _close(out, ref_out, 1e-4)
    _close(lse, ref_lse, 1e-4)
    cpu_out, cpu_lse = tbg.gat_fwd_plain(plan.bits[:N_DST], el, er, h, 0.2)
    _close(out.cpu(), cpu_out, 1e-4)
    _close(lse.cpu(), cpu_lse, 1e-4)
    empty = torch.from_numpy(deg == 0).to(card)
    assert int(empty.sum()) >= 100
    assert not out[empty].any()
    assert torch.all(lse[empty] == float(np.log(np.float32(1e-30))))


def test_kernels_reject_wrong_inputs(card, bitmap_plans):
    plan, _ = bitmap_plans
    bits = plan.bits.to(card)
    with pytest.raises(ValueError, match="uint8"):
        bitmap_matmul(bits.to(torch.int32), torch.ones(N_SRC, 4, device=card))
    with pytest.raises(ValueError, match="does not fit"):
        bitmap_matmul(bits[:, :512], torch.ones(N_SRC, 4, device=card))
    h = torch.ones(N_SRC, 2, 4, device=card)
    el = torch.ones(N_SRC, 2, device=card)
    with pytest.raises(ValueError, match="bf16"):
        tbg.bitmap_gat_fwd(bits, el, el[:N_DST], h, 0.2, N_DST)
    with pytest.raises(ValueError, match="el must be"):
        tbg.bitmap_gat_fwd(bits, el[:, :1], el[:N_DST],
                           h.to(torch.bfloat16), 0.2, N_DST)


def test_gcn_and_gat_launch_the_kernels(card):
    """Through the entry points: gspmm's bitmap branch launches B2 and
    GATConv's bitmap route launches B3, once per call."""
    rng = np.random.default_rng(5)
    n = 3000
    src, dst = rng.integers(0, n, 40000), rng.integers(0, n, 40000)
    loops = np.arange(n)
    src = np.concatenate([src, dst, loops])
    dst = np.concatenate([dst, src[:40000], loops])
    flat = np.unique(dst * n + src)
    src, dst = flat % n, flat // n
    g = dt.graph((src, dst), num_nodes=n, device=card).with_spmm_plans(
        num_hubs=128, dense_attn=False)
    g_cpu = g.to("cpu")
    assert g._relation().bitmap_plan.bits.is_cuda
    x = torch.from_numpy(rng.normal(size=(n, 24)).astype(np.float32))
    _kernels.reset_launch_counts()
    with torch.inference_mode():
        out = dt.ops.copy_u_mean(g, x.to(card))
        torch.cuda.synchronize()
        assert _kernels.launch_counts["bitmap_spmm"] == 1
        _close(out.cpu(), dt.ops.copy_u_mean(g_cpu, x), 1e-5)
        conv = GATConv(24, 8, 4, generator=torch.Generator().manual_seed(0),
                       device=card).eval()
        conv_cpu = GATConv(24, 8, 4, device="cpu").eval()
        conv_cpu.load_state_dict({k: v.cpu()
                                  for k, v in conv.state_dict().items()})
        out = conv(g, x.to(card))
        torch.cuda.synchronize()
        assert _kernels.launch_counts["bitmap_gat_fwd"] == 1
        # the card's f32 projection differs from the CPU's in the last bit,
        # which can move a bf16 rounding of h: compare at 2**-8
        ref = conv_cpu(g_cpu, x)
        torch.testing.assert_close(out.cpu(), ref, rtol=0,
                                   atol=2.0 ** -8 * ref.abs().max().item())
