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
from chip_smoke import EDGE_CASES, FWD_CASES, SWITCH_CASES, TILE_LEVEL_ENDS
from dgl_tpu_torch import _kernels
from dgl_tpu_torch.models import GAT, GCN, GraphSAGE
from dgl_tpu_torch.nn import GATConv
from dgl_tpu_torch.ops import bitmap_gat as tbg
from dgl_tpu_torch.ops import hub_spmm
from dgl_tpu_torch.ops._precision import full_f32
from dgl_tpu_torch.ops.bitmap_spmm import (
    bitmap_copy_u_sum, bitmap_matmul, bitmap_matmul_plain, build_bitmap_plan,
    unpack_host)
from dgl_tpu_torch.ops.hub_cache import HubPlan, _hub_gather_plain, hub_gather
from dgl_tpu_torch.ops.hub_cache import hub_copy_u_sum as hub_cache_copy_u_sum
from dgl_tpu_torch.ops.hub_spmm import build_hub_plan, hub_copy_u_sum
from dgl_tpu_torch.ops.shell_prefix import (
    flat_shell_indices, shell_prefix_sum, shell_prefix_sum_plain)

pytestmark = pytest.mark.gpu

LEVELS = [1500, 1104, 600, 17, 8]  # non-increasing, as the shells are
N_TABLE = 2000
# 32 levels (SHELL_CAP) ending at the edges of the kernel's tiles of rows
TILE_LEVELS = list(TILE_LEVEL_ENDS)
# (F, levels): F = 13 takes the scalar path; the 32-level layout at the
# scalar path, at six rows a warp (F = 40) and at one (F = 256)
B1_CASES = [(40, LEVELS), (128, LEVELS), (256, LEVELS), (13, LEVELS),
            (13, TILE_LEVELS), (40, TILE_LEVELS), (256, TILE_LEVELS)]
B1_IDS = ["40", "128", "256", "13", "tiles-13", "tiles-40", "tiles-256"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _shell_inputs(feat, seed, levels=LEVELS):
    """bf16 table, per-level indices with out-of-range slots (the table's
    size; in the 32-level layout also -1 and the int32 extremes), and an
    f32 base."""
    rng = np.random.default_rng(seed)
    table = torch.from_numpy(rng.normal(size=(N_TABLE, feat)).astype(
        np.float32)).to(torch.bfloat16)
    idx = [rng.integers(0, N_TABLE + 1, m).astype(np.int32) for m in levels]
    if levels is TILE_LEVELS:
        for v in idx:
            bad = rng.random(v.shape[0]) < 0.05
            v[bad] = rng.choice(np.array([-1, -2**31, 2**31 - 1], np.int32),
                                int(bad.sum()))
    base = torch.from_numpy(rng.normal(size=(levels[0] + 8, feat)).astype(
        np.float32))
    return table, [torch.from_numpy(v) for v in idx], base


@pytest.mark.parametrize("n_out", [LEVELS[0] + 5, 1000])
@pytest.mark.parametrize("feat,levels", B1_CASES, ids=B1_IDS)
def test_kernel_matches_plain(card, feat, levels, n_out):
    """Both sum the same f32 values in the same order: equal to the bit.
    F = 13 takes the scalar path; n_out = 1000 cuts the deeper levels (and
    both cut the 32-level layout's first levels)."""
    table, idx, base = _shell_inputs(feat, 3, levels)
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
        torch.testing.assert_close(out, ref, rtol=0, atol=0)
        cpu = shell_prefix_sum_plain(table, flat, rows, n_out,
                                     base=None if b is None else b.cpu())
        torch.testing.assert_close(out.cpu(), cpu, rtol=1e-5, atol=1e-5)


def test_kernel_rejects_wrong_inputs(card):
    table, idx, _ = _shell_inputs(40, 4)
    flat, rows = flat_shell_indices(idx, LEVELS[0], oob_index=N_TABLE)
    # bf16 and f32 tables have a kernel each (B1, B1f); no other type does
    with pytest.raises(ValueError, match="bf16 or f32"):
        shell_prefix_sum(table.half().to(card), flat.to(card), rows,
                         LEVELS[0])
    with pytest.raises(ValueError, match="int32"):
        shell_prefix_sum(table.to(card), flat.long().to(card), rows,
                         LEVELS[0])
    with pytest.raises(ValueError, match="shorter"):
        shell_prefix_sum(table.to(card), flat[:100].to(card), rows,
                         LEVELS[0])
    # at most 32 levels, nested: no fallback above the kernel's level table
    flat33 = torch.full((33 * 512,), N_TABLE, dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="SHELL_CAP"):
        shell_prefix_sum(table.to(card), flat33, [512] * 33, 512)
    with pytest.raises(ValueError, match="increase"):
        shell_prefix_sum(table.to(card), flat.to(card), rows[::-1],
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


@pytest.mark.parametrize("n_out", [LEVELS[0] + 5, 1000])
@pytest.mark.parametrize("feat,levels", B1_CASES, ids=B1_IDS)
def test_b1f_kernel_equals_plain(card, feat, levels, n_out):
    """B1f, the kernel's f32 instantiation (the hub plan's
    ``cold="shell-f32"``), adds the same f32 values in the same order as
    its plain version: equal to the bit, with and without a base, on the
    16-byte path and the scalar one (F = 13, an unaligned base), over 5
    levels and over 32 that end at the kernel's tile edges."""
    _table, idx, base = _shell_inputs(feat, 5, levels)
    table = torch.from_numpy(np.random.default_rng(feat).normal(
        size=(N_TABLE, feat)).astype(np.float32))
    flat, rows = flat_shell_indices(idx, n_out, oob_index=N_TABLE)
    table_c, flat_c = table.to(card), flat.to(card)
    rows_b = base.shape[0] - 1
    shifted = base.to(card).reshape(-1)[1:1 + rows_b * feat].view(rows_b, feat)
    for b in (None, base.to(card), shifted):
        before = dict(_kernels.launch_counts)
        out = shell_prefix_sum(table_c, flat_c, rows, n_out, base=b)
        torch.cuda.synchronize()
        assert _kernels.launch_counts["shell_prefix_sum_f32"] == before[
            "shell_prefix_sum_f32"] + 1
        assert _kernels.launch_counts["shell_prefix_sum"] == before[
            "shell_prefix_sum"]
        ref = shell_prefix_sum_plain(table_c, flat_c, rows, n_out, base=b)
        torch.testing.assert_close(out, ref, rtol=0, atol=0)
        cpu = shell_prefix_sum_plain(table, flat, rows, n_out,
                                     base=None if b is None else b.cpu())
        torch.testing.assert_close(out.cpu(), cpu, rtol=0, atol=0)


def _exact_hub_graph():
    rng = np.random.default_rng(9)
    n, e = 6000, 48000
    w = 1.0 / np.arange(1, n + 1)
    src = rng.choice(n, e, p=w / w.sum())
    dst = rng.choice(n, e, p=(w ** 0.7) / (w ** 0.7).sum())  # a residual
    return dt.graph((src, dst), num_nodes=n, device="cpu"), n


# (precision, cold) -> (B1 launches, B1f launches) of a forward and its
# backward: one a direction in the shell modes, none in the segment modes
HUB_MODES = {("f32", "f32"): (0, 0), ("f32", "shell-f32"): (0, 2),
             ("int8", "bf16"): (0, 0), ("int8", "shell"): (2, 0),
             ("bf16", "shell-f32"): (0, 2), ("f32", "shell"): (2, 0)}


@pytest.mark.parametrize("precision,cold", list(HUB_MODES))
def test_hub_modes_on_card(card, precision, cold):
    """Each (precision, cold) pair on the card: its launch counts, and its
    forward and gradient against the same plan on the CPU (rtol = 1e-5,
    atol = 1e-5 * max|ref| in the exact modes, 1e-4 where rows round to
    bf16: the same products summed in another order)."""
    g, n = _exact_hub_graph()
    plan = build_hub_plan(g._relation(), 256, precision, cold=cold)
    assert plan.cold == cold
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(n, 64)).astype(np.float32))
    dz = torch.from_numpy(rng.normal(size=(n, 64)).astype(np.float32))
    xr = x.clone().requires_grad_()
    ref = hub_copy_u_sum(plan, xr)
    (ref * dz).sum().backward()
    xc = x.to(card).requires_grad_()
    _kernels.reset_launch_counts()
    out = hub_copy_u_sum(plan.to(card), xc)
    (out * dz.to(card)).sum().backward()
    torch.cuda.synchronize()
    b1, b1f = HUB_MODES[(precision, cold)]
    assert (_kernels.launch_counts["shell_prefix_sum"],
            _kernels.launch_counts["shell_prefix_sum_f32"]) == (b1, b1f)
    tol = 1e-5 if (precision, cold) in (("f32", "f32"),
                                        ("f32", "shell-f32")) else 1e-4
    for got, want in ((out.detach(), ref.detach()), (xc.grad, xr.grad)):
        scale = want.abs().max().item()
        torch.testing.assert_close(got.cpu(), want, rtol=tol,
                                   atol=tol * scale)


@pytest.mark.parametrize("cold", ["f32", "shell-f32"])
def test_f32_hub_plan_ignores_tf32(card, cold):
    """With ``allow_tf32 = True`` set in the process, the f32 plan's forward
    and gradient still match the graph without plans (``index_add_`` in
    f32) at rtol = 1e-5, atol = 1e-5 * max|ref|: an f32 hub matmul at TF32
    would be off by about 1e-3. The flag is as it was after each call."""
    g, n = _exact_hub_graph()
    gc = g.to(card)
    gp = gc.with_spmm_plans(num_hubs=256, precision="f32", bitmap=False,
                            dense_attn=False)
    if cold == "shell-f32":
        rel = gp._relation()
        gp._relations = {k: rel.with_hub_plan(build_hub_plan(
            rel, 256, "f32", cold=cold)) for k in gp._relations}
    assert gp._relation().hub_plan.cold == cold
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.normal(size=(n, 64)).astype(np.float32)).to(card)
    dz = torch.from_numpy(rng.normal(size=(n, 64)).astype(np.float32)).to(card)
    before = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        got = []
        for graph in (gp, gc):
            xg = x.clone().requires_grad_()
            out = dt.ops.copy_u_sum(graph, xg)
            (out * dz).sum().backward()
            got.append((out.detach(), xg.grad))
            assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
    for a, b in zip(*got):
        scale = b.abs().max().item()
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5 * scale)


def _bipartite_relation(case):
    """B1's hub caller on bipartite relations (``num_src != num_dst``), as
    a heterogeneous graph's ``with_spmm_plans`` builds them:

    - ``few_dst``: 30,000 zipf sources into 300 destinations, far fewer
      rows than the 2,048 hubs (a forward residual: 400 in-edges a row);
    - ``empty_dst``: 5,000 sources into 9,000 destinations, 4,000 of them
      with no in-edge;
    - ``all_hubs``: 500 sources, every one a hub: no cold edge, so no shell
      in either direction and no launch.
    """
    rng = np.random.default_rng({"few_dst": 1, "empty_dst": 2,
                                 "all_hubs": 3}[case])
    n_src, n_dst, e = {"few_dst": (30_000, 300, 120_000),
                       "empty_dst": (5_000, 9_000, 40_000),
                       "all_hubs": (500, 7_000, 20_000)}[case]
    w = 1.0 / np.arange(1, n_src + 1)
    src = rng.choice(n_src, e, p=w / w.sum())
    dst = rng.integers(0, n_dst if case != "empty_dst" else 5_000, e)
    data = {("a", "r", "b"): (src, dst)}
    g = dt.heterograph(data, {"a": n_src, "b": n_dst}, device="cpu")
    return g._relation(), n_src, n_dst


@pytest.mark.parametrize("case", ["few_dst", "empty_dst", "all_hubs"])
def test_b1_on_bipartite_hub_plans(card, case):
    """The plan built on the card equals the CPU's; B1 against its plain
    version on both directions' shells (rtol = atol = 1e-5, the same sums
    in the same order), and ``hub_copy_u_sum``'s forward and backward on
    the card against the CPU (rtol = atol = 1e-4 of max|ref|: bf16
    products summed in another order), with one launch a direction that
    has shells and none where it has none."""
    rel, n_src, n_dst = _bipartite_relation(case)
    plan = build_hub_plan(rel, 2048, "int8")
    cplan = build_hub_plan(rel.to(card), 2048, "int8")
    assert tuple(cplan.a_hub.shape) == (n_dst, plan.num_hubs)
    torch.testing.assert_close(cplan.a_hub.cpu(), plan.a_hub, rtol=0, atol=0)
    for f in ("hub_ids", "shell_idx", "rev_shell_idx"):
        a, b = getattr(cplan, f), getattr(plan, f)
        assert (a is None) == (b is None)
        assert b is None or torch.equal(a.cpu(), b)
    if case == "few_dst":
        assert n_dst < plan.num_hubs and plan.res_dst is not None
    if case == "empty_dst":
        assert int((rel.in_degrees() == 0).sum()) >= 4_000
    if case == "all_hubs":
        assert not plan.shell_rows and not plan.rev_shell_rows
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(n_src, 64)).astype(np.float32))
    dz = torch.from_numpy(rng.normal(size=(n_dst, 64)).astype(np.float32))
    for reverse, table in ((False, x), (True, dz)):
        flat, rows, levels, _res, _unrank, n_out = cplan.direction(reverse)
        if not rows:
            continue
        xg = table.to(card).to(torch.bfloat16)
        base = hub_spmm._residual_base(xg, cplan, reverse)
        out = shell_prefix_sum(xg, flat, rows, n_out, base=base,
                               levels=levels)
        ref = shell_prefix_sum_plain(xg, flat, rows, n_out, base=base)
        torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
        assert out.shape == (n_dst if not reverse else n_src, 64)
    ref_out = hub_copy_u_sum(plan, x.requires_grad_())
    (ref_out * dz).sum().backward()
    xc = x.detach().to(card).requires_grad_()
    before = _kernels.launch_counts["shell_prefix_sum"]
    out = hub_copy_u_sum(cplan, xc)
    (out * dz.to(card)).sum().backward()
    torch.cuda.synchronize()
    expect = int(bool(plan.shell_rows)) + int(bool(plan.rev_shell_rows))
    assert _kernels.launch_counts["shell_prefix_sum"] == before + expect
    for got, want in ((out.detach(), ref_out.detach()), (xc.grad, x.grad)):
        scale = want.abs().max().item()
        torch.testing.assert_close(got.cpu(), want, rtol=1e-4,
                                   atol=1e-4 * scale)


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
def bitmap_rel():
    src, dst = _bitmap_edges(11)
    return dt.Relation.from_coo(src, dst, N_SRC, N_DST, device="cpu")


@pytest.fixture(scope="module")
def bitmap_plans(bitmap_rel):
    plan = build_bitmap_plan(bitmap_rel)
    return plan, np.bincount(_bitmap_edges(11)[1], minlength=N_DST)


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


B2_FEATS = [1, 8, 16, 24, 41, 64, 130]  # G = 1, 1, 2, 4, 8, 8; 130: 3 passes


def _x(n, feat, seed):
    return torch.from_numpy(np.random.default_rng(seed).normal(
        size=(n, feat)).astype(np.float32))


@pytest.mark.parametrize("feat", B2_FEATS)
def test_bitmap_spmm_kernel_matches_plain(card, bitmap_plans, bitmap_rel,
                                          feat):
    """B2 walks the relation's CSC, its plain version reads the bits (on the
    card and on the CPU): the same f32 terms summed in another order.
    Rows without an in-edge are 0; a second launch gives the same bits.
    The transpose walks the CSR against the plain version over
    ``bits_rev``."""
    plan, deg = bitmap_plans
    x = _x(N_SRC, feat, feat)
    bits = plan.bits.to(card)
    csc, csr = _index(bitmap_rel, card)
    idx = dict(zip(("indptr", "indices"), csc))
    before = _kernels.launch_counts["bitmap_spmm"]
    out = bitmap_matmul(bits, x.to(card), N_DST, **idx)
    torch.cuda.synchronize()
    assert _kernels.launch_counts["bitmap_spmm"] == before + 1
    assert out.shape == (N_DST, feat) and out.dtype == torch.float32
    _close(out, bitmap_matmul_plain(bits, x.to(card), N_DST), 1e-5)
    _close(out.cpu(), bitmap_matmul_plain(plan.bits, x, N_DST), 1e-5)
    assert not out[torch.from_numpy(deg == 0).to(card)].any()
    assert torch.equal(bitmap_matmul(bits, x.to(card), N_DST, **idx), out)
    # the kernel reads no bits: none passed, n_rows from indptr
    assert torch.equal(bitmap_matmul(None, x.to(card), **idx), out)
    # the transpose over the CSR: a different row count and id range
    dz = _x(N_DST, feat, feat + 1)
    out_t = bitmap_matmul(plan.bits_rev.to(card), dz.to(card), N_SRC,
                          indptr=csr[0], indices=csr[1])
    _close(out_t.cpu(), bitmap_matmul_plain(plan.bits_rev, dz, N_SRC), 1e-5)
    ones = bitmap_matmul(plan.bits_rev.to(card),
                         torch.ones(N_DST, feat, device=card), N_SRC,
                         indptr=csr[0], indices=csr[1])
    want_t = torch.from_numpy(np.bincount(
        _bitmap_edges(11)[0], minlength=N_SRC).astype(np.float32))
    torch.testing.assert_close(ones.cpu(), want_t[:, None].expand(-1, feat))


@pytest.mark.parametrize("feat", B2_FEATS)
def test_b2f_kernel_matches_plain(card, bitmap_plans, bitmap_rel, feat):
    """B2f, the kernel's f32 instantiation (``compute_dtype="float32"``),
    over the relation's CSC (its transpose over the CSR) against its plain
    version over the bits: the same f32 rows summed in another order,
    within 1e-6 * max|ref|; the f32 rows are not rounded to bf16."""
    plan, deg = bitmap_plans
    x = _x(N_SRC, feat, feat)
    bits = plan.bits.to(card)
    csc, csr = _index(bitmap_rel, card)
    idx = dict(zip(("indptr", "indices"), csc))
    before = dict(_kernels.launch_counts)
    out = bitmap_matmul(bits, x.to(card), N_DST, "float32", **idx)
    torch.cuda.synchronize()
    assert _kernels.launch_counts["bitmap_spmm_f32"] == before[
        "bitmap_spmm_f32"] + 1
    assert _kernels.launch_counts["bitmap_spmm"] == before["bitmap_spmm"]
    for want in (bitmap_matmul_plain(bits, x.to(card), N_DST,
                                     compute_dtype="float32"),
                 bitmap_matmul_plain(plan.bits, x, N_DST,
                                     compute_dtype="float32").to(card)):
        scale = want.abs().max().item()
        torch.testing.assert_close(out, want, rtol=1e-6, atol=1e-6 * scale)
    bf = bitmap_matmul(bits, x.to(card), N_DST, **idx)
    assert not torch.allclose(out, bf, rtol=1e-6, atol=1e-6)
    assert not out[torch.from_numpy(deg == 0).to(card)].any()
    assert torch.equal(
        bitmap_matmul(bits, x.to(card), N_DST, "float32", **idx), out)
    dz = _x(N_DST, feat, feat + 1)
    out_t = bitmap_matmul(plan.bits_rev.to(card), dz.to(card), N_SRC,
                          "float32", indptr=csr[0], indices=csr[1])
    want_t = bitmap_matmul_plain(plan.bits_rev, dz, N_SRC,
                                 compute_dtype="float32")
    torch.testing.assert_close(out_t.cpu(), want_t, rtol=1e-6,
                               atol=1e-6 * want_t.abs().max().item())


@pytest.mark.parametrize("compute_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("feat", B2_FEATS)
def test_bitmap_spmm_degree_extremes(card, feat, compute_dtype):
    """B2 and B2f at the edges of their walk: chip_smoke.py's
    ``fwd_edge_case_csc`` (dst rows of in-degree 0, 1, 31, 32, 33, around
    64, 128 and 256, 1,000 and more, a row holding every source; sink
    indices in the CSC, which must be skipped) and its transpose over the
    CSR (``bwd_edge_case_csr``, sinks there too), against the plain version
    over the bits: rtol = 1e-5, atol = 1e-5 * max|ref| (f32: 1e-6). Rows
    without a real edge are 0."""
    from chip_smoke import (FWD_N_DST, FWD_N_SRC, bwd_edge_case_csr,
                            fwd_edge_case_csc)

    tol = 1e-5 if compute_dtype == "bfloat16" else 1e-6
    for make, transpose in ((fwd_edge_case_csc, False),
                            (bwd_edge_case_csr, True)):
        plan, (indptr, indices), deg = make(card)
        bits = plan.bits_rev if transpose else plan.bits
        assert int(indices.max()) == FWD_N_SRC  # the sinks are there
        assert int(deg.max()) == FWD_N_SRC and bool((deg == 0).any())
        x = _x(FWD_N_SRC, feat, feat).to(card)
        out = bitmap_matmul(bits, x, FWD_N_DST, compute_dtype,
                            indptr=indptr, indices=indices)
        want = bitmap_matmul_plain(bits, x, FWD_N_DST,
                                   compute_dtype=compute_dtype)
        torch.cuda.synchronize()
        scale = want.abs().max().item()
        torch.testing.assert_close(out, want, rtol=tol, atol=tol * scale)
        assert not out[deg == 0].any()


def test_b2f_copy_u_sum_step_launches(card, bitmap_rel):
    """A float32 bitmap plan: 1 B2f launch forward (over the relation's
    CSC) and 1 backward (over its CSR), none of B2, and the gradient
    against the graph without plans at f32 rounding."""
    rel = bitmap_rel.to(card)
    plan = build_bitmap_plan(rel, compute_dtype="float32")
    assert plan.compute_dtype == "float32"
    x = torch.randn(N_SRC, 16, device=card, requires_grad=True)
    dz = torch.randn(N_DST, 16, device=card)
    _kernels.reset_launch_counts()
    out = bitmap_copy_u_sum(plan, x, rel)
    (out * dz).sum().backward()
    torch.cuda.synchronize()
    assert _kernels.launch_counts["bitmap_spmm_f32"] == 2
    assert _kernels.launch_counts["bitmap_spmm"] == 0
    dense = torch.from_numpy(unpack_host(plan.bits.cpu().numpy())[
        :N_DST, :N_SRC].astype(np.float32)).to(card)
    with full_f32():
        want, want_dx = dense @ x.detach(), dense.t() @ dz
    for a, b in ((out.detach(), want), (x.grad, want_dx)):
        scale = b.abs().max().item()
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5 * scale)


def test_int64_graph_takes_the_hub_route(card):
    """An int64 graph gets no bitmap plan from ``with_spmm_plans`` (B2-B5
    walk an int32 index), so ``copy_u_sum`` over it launches no B2 and
    equals the int32 graph's, which runs B2, within bf16 rounding."""
    src, dst = _bitmap_edges(11)
    n = N_SRC
    x = _x(n, 16, 5).to(card)
    out = {}
    for idtype in (torch.int32, torch.int64):
        g = dt.graph((src, dst), num_nodes=n, idtype=idtype, device=card)
        gp = g.with_spmm_plans(num_hubs=64, bitmap=True)
        assert (gp._relation().bitmap_plan is not None) == (
            idtype == torch.int32)
        _kernels.reset_launch_counts()
        out[idtype] = dt.ops.copy_u_sum(gp, x)
        torch.cuda.synchronize()
        assert (_kernels.launch_counts["bitmap_spmm"] == 1) == (
            idtype == torch.int32)
    want = out[torch.int32]
    torch.testing.assert_close(out[torch.int64], want, rtol=2e-2,
                               atol=2e-2 * want.abs().max().item())


def _b3(bits, csc, el, er, h, n_rows, nf):
    """B3 through its wrapper (the fewest passes), or at another ``nf``
    through the private launcher after the wrapper's checks."""
    if nf is None:
        return tbg.bitmap_gat_fwd(bits, *csc, el, er, h, 0.2, n_rows)
    tbg._check_fwd(bits, *csc, el, er, h, n_rows)
    return tbg._launch(*csc, el, er, h, 0.2, n_rows, nf)


@pytest.mark.parametrize("nf", [None, 8, 16, 32, 64])
@pytest.mark.parametrize("heads,odim", [(8, 8), (1, 41), (3, 5), (2, 130)])
def test_bitmap_gat_kernel_matches_plain(card, bitmap_plans, bitmap_rel,
                                         heads, odim, nf):
    """B3 walks the relation's CSC, the plain version reads the bits. (3, 5)
    pads heads and features; (2, 130) runs three feature passes at nf = 64;
    every nf (given to the private launcher; the wrapper takes the fewest
    passes) reaches another case of the kernel's switch. rtol = 1e-4,
    atol = 1e-5 * max|ref|: the exponentials and sums run in another order
    (an online softmax merged across lanes)."""
    plan, deg = bitmap_plans
    rng = np.random.default_rng(heads * 1000 + odim)
    el = torch.from_numpy(rng.normal(size=(N_SRC, heads)).astype(np.float32))
    er = torch.from_numpy(rng.normal(size=(N_DST, heads)).astype(np.float32))
    h = torch.from_numpy(rng.normal(size=(N_SRC, heads, odim)).astype(
        np.float32)).to(torch.bfloat16)
    bits = plan.bits.to(card)
    csc = bitmap_rel.csc_indptr.to(card), bitmap_rel.csc_indices.to(card)
    before = _kernels.launch_counts["bitmap_gat_fwd"]
    out, lse = _b3(bits, csc, el.to(card), er.to(card), h.to(card), N_DST,
                   nf)
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


@pytest.mark.parametrize("heads,odim,nf", [
    (1, 5, None), (2, 8, None), (3, 7, None), (12, 8, None), (1, 16, None),
    (2, 12, None), (5, 16, None), (1, 32, None), (3, 20, None),
    (2, 130, None), (1, 41, 16), (1, 41, 64)])
def test_bitmap_gat_fwd_edge_cases(card, heads, odim, nf):
    """B3 against its plain version at B3's tolerance on rows of in-degree
    0, 1, 31, 32, 33 (and around 64, 128, 256 sources), 1,000 and more, a
    row holding every source, and sink indices that must be skipped; both
    feature widths at O = 41 (o_pad 48 and 64). Rows without a real edge
    get out = 0 and lse = log(1e-30) exactly. The graph is chip_smoke.py's
    ``fwd_edge_case_csc``, which holds B3 to the same cases."""
    from chip_smoke import FWD_N_DST, FWD_N_SRC, fwd_edge_case_csc

    plan, csc, deg = fwd_edge_case_csc(card)
    assert int(deg.max()) == FWD_N_SRC
    rng = np.random.default_rng(heads * 100 + odim)
    t = lambda *s: torch.from_numpy(  # noqa: E731
        rng.normal(size=s).astype(np.float32)).to(card)
    el, er = t(FWD_N_SRC, heads), t(FWD_N_DST, heads)
    h = t(FWD_N_SRC, heads, odim).to(torch.bfloat16)
    bits = plan.bits
    out, lse = _b3(bits, csc, el, er, h, FWD_N_DST, nf)
    ref_out, ref_lse = tbg.gat_fwd_plain(bits[:FWD_N_DST], el, er, h, 0.2)
    torch.cuda.synchronize()
    _close(out, ref_out, 1e-4)
    _close(lse, ref_lse, 1e-4)
    empty = deg == 0
    assert int(empty.sum()) >= 100 and bool(empty[25])
    assert not out[empty].any()
    assert torch.all(lse[empty] == float(np.log(np.float32(1e-30))))


def test_kernels_reject_wrong_inputs(card, bitmap_plans, bitmap_rel):
    plan, _ = bitmap_plans
    bits = plan.bits.to(card)
    csc = bitmap_rel.csc_indptr.to(card), bitmap_rel.csc_indices.to(card)
    x4 = torch.ones(N_SRC, 4, device=card)
    # the bits are the plain version's input: checked where it reads them,
    # on the CPU; the card's kernel reads none, so it does not look at them
    with pytest.raises(ValueError, match="uint8"):
        bitmap_matmul(plan.bits.to(torch.int32), x4.cpu(), N_DST)
    with pytest.raises(ValueError, match="does not fit"):
        bitmap_matmul(plan.bits[:, :512], x4.cpu(), N_DST)
    want = bitmap_matmul(None, x4, N_DST, indptr=csc[0], indices=csc[1])
    for unread in (bits.to(torch.int32), bits[:, :512]):
        assert torch.equal(bitmap_matmul(unread, x4, N_DST, indptr=csc[0],
                                         indices=csc[1]), want)
    # B2 walks the relation's index: on the card it must be there, int32,
    # on x's device, one entry a row more than the rows
    with pytest.raises(ValueError, match="indptr must be"):
        bitmap_matmul(bits, x4, N_DST)
    with pytest.raises(ValueError, match="indices must be"):
        bitmap_matmul(bits, x4, N_DST, indptr=csc[0],
                      indices=csc[1].long())
    with pytest.raises(ValueError, match="indices must be"):
        bitmap_matmul(bits, x4, N_DST, indptr=csc[0], indices=csc[1].cpu())
    with pytest.raises(ValueError, match="entries"):
        bitmap_matmul(bits, x4, N_DST - 1, indptr=csc[0], indices=csc[1])
    with pytest.raises(ValueError, match="the relation's CSC"):
        bitmap_copy_u_sum(plan.to(card), x4)
    h = torch.ones(N_SRC, 2, 4, device=card)
    el = torch.ones(N_SRC, 2, device=card)
    with pytest.raises(ValueError, match="bf16"):
        tbg.bitmap_gat_fwd(bits, *csc, el, el[:N_DST], h, 0.2, N_DST)
    hb = h.to(torch.bfloat16)
    with pytest.raises(ValueError, match="el must be"):
        tbg.bitmap_gat_fwd(bits, *csc, el[:, :1], el[:N_DST], hb, 0.2,
                           N_DST)
    # the kernel walks the CSC: on the card it must be there, int32
    with pytest.raises(ValueError, match="indptr must be"):
        tbg.bitmap_gat_fwd(bits, None, None, el, el[:N_DST], hb, 0.2, N_DST)
    with pytest.raises(ValueError, match="indices must be"):
        tbg.bitmap_gat_fwd(bits, csc[0], csc[1].long(), el, el[:N_DST], hb,
                           0.2, N_DST)
    with pytest.raises(ValueError, match="indices must be"):
        tbg.bitmap_gat_fwd(bits, csc[0], csc[1].cpu(), el, el[:N_DST], hb,
                           0.2, N_DST)
    with pytest.raises(ValueError, match="entries"):
        tbg.bitmap_gat_fwd(bits, *csc, el, el[:N_DST], hb, 0.2, N_DST - 1)


def test_bitmap_gat_rejects_another_relation(card, bitmap_plans,
                                             bitmap_rel):
    """The plan and the relation must agree on num_src, num_dst and the
    edge count, and an int64 relation is refused, not converted."""
    plan = bitmap_plans[0].to(card)
    el = torch.ones(N_SRC, 2, device=card)
    er = torch.ones(N_DST, 2, device=card)
    h = torch.ones(N_SRC, 2, 4, device=card)
    src, dst = _bitmap_edges(11)
    fewer = dt.Relation.from_coo(src[1:], dst[1:], N_SRC, N_DST, device=card)
    with pytest.raises(ValueError, match="num_edges"):
        tbg.bitmap_gat(0.2, plan, el, er, h, fewer)
    wide = dt.Relation.from_coo(src, dst, N_SRC + 1, N_DST, device=card)
    with pytest.raises(ValueError, match="num_src"):
        tbg.bitmap_gat(0.2, plan, torch.ones(N_SRC + 1, 2, device=card), er,
                       torch.ones(N_SRC + 1, 2, 4, device=card), wide)
    wide64 = dt.Relation.from_coo(src, dst, N_SRC, N_DST, device=card,
                                  idtype=torch.int64)
    with pytest.raises(ValueError, match="int32"):
        tbg.bitmap_gat(0.2, plan, el, er, h, wide64)
    out = tbg.bitmap_gat(0.2, plan, el, er, h, bitmap_rel.to(card))
    torch.cuda.synchronize()
    assert out.shape == (N_DST, 2, 4)


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


# ---------------------------------------------------------------------------
# the backward: B4 (bitmap_gat_bwd_dst), B5 (bitmap_gat_bwd_src), and B2 and
# B1 over the transposed structures
# ---------------------------------------------------------------------------


def _symmetric_plan():
    """A symmetric relation on N_SRC nodes with nodes 4500..4599 isolated
    and a full tile: nodes 0..31 joined to every node 0..4095. Returns its
    bitmap plan and the relation."""
    src, dst = _bitmap_edges(13)
    keep = ((src < 4500) | (src >= 4600)) & ((dst < 4500) | (dst >= 4600))
    src, dst = np.concatenate([src[keep], dst[keep]]), np.concatenate(
        [dst[keep], src[keep]])
    flat = np.unique(dst.astype(np.int64) * N_SRC + src)
    rel = dt.Relation.from_coo(flat % N_SRC, flat // N_SRC, N_SRC, N_SRC,
                               device="cpu")
    plan = build_bitmap_plan(rel)
    assert plan.bits_rev is None
    return plan, rel


def _bwd_inputs(plan, heads, odim, seed):
    n_src, n_dst = plan.num_src, plan.num_dst
    rng = np.random.default_rng(seed)
    t = lambda *s: torch.from_numpy(  # noqa: E731
        rng.normal(size=s).astype(np.float32))
    el, er = t(n_src, heads), t(n_dst, heads)
    h = t(n_src, heads, odim).to(torch.bfloat16)
    out, lse = tbg.gat_fwd_plain(plan.bits[:n_dst], el, er, h, 0.2)
    dz = t(n_dst, heads, odim)  # c from the f32 dz, the kernels' dz in bf16
    return el, er, h, lse, (out * dz).sum(-1), dz.to(torch.bfloat16)


def _index(rel, device):
    """The relation's CSC (B4's input) and CSR (B5's) on ``device``."""
    return ((rel.csc_indptr.to(device), rel.csc_indices.to(device)),
            (rel.csr_indptr.to(device), rel.csr_indices.to(device)))


@pytest.mark.parametrize("symmetric", [False, True])
@pytest.mark.parametrize("heads,odim", [(8, 8), (1, 41), (3, 5), (2, 130)])
def test_bitmap_gat_bwd_kernels_match_plain(card, bitmap_plans, bitmap_rel,
                                            symmetric, heads, odim):
    """B4 over the relation's CSC and B5 over its CSR against their plain
    versions over ``bits`` and its transpose (``bits_rev``, or ``bits``
    itself when symmetric), on the card and on the CPU: rows without an
    edge, a full 4096-source tile, padded heads and features (3, 5) and
    three feature walks (2, 130). rtol = 1e-4, atol = 1e-5 * max|ref|, B3's
    tolerance (exponentials and sums in another order)."""
    plan, rel = _symmetric_plan() if symmetric else (bitmap_plans[0],
                                                     bitmap_rel)
    bits_t = plan.bits if plan.bits_rev is None else plan.bits_rev
    ins = _bwd_inputs(plan, heads, odim, heads * 100 + odim)
    el, er, h, lse, c, dz = (x.to(card) for x in ins)
    n_src, n_dst = plan.num_src, plan.num_dst
    bits, bits_tc = plan.bits.to(card), bits_t.to(card)
    csc, csr = _index(rel, card)
    before = dict(_kernels.launch_counts)
    der = tbg.bitmap_gat_bwd_dst(bits, *csc, el, er, h, 0.2, lse, c, dz,
                                 n_dst)
    dele, dh = tbg.bitmap_gat_bwd_src(bits_tc, *csr, el, er, h, 0.2, lse, c,
                                      dz, n_src)
    torch.cuda.synchronize()
    assert _kernels.launch_counts["bitmap_gat_bwd_dst"] == (
        before["bitmap_gat_bwd_dst"] + 1)
    assert _kernels.launch_counts["bitmap_gat_bwd_src"] == (
        before["bitmap_gat_bwd_src"] + 1)
    assert der.shape == (n_dst, heads) and dh.shape == (n_src, heads, odim)
    want_der = tbg.gat_bwd_dst_plain(bits[:n_dst], el, er, h, 0.2, lse, c,
                                     dz)
    want_del, want_dh = tbg.gat_bwd_src_plain(bits_tc[:n_src], el, er, h,
                                              0.2, lse, c, dz)
    _close(der, want_der, 1e-4)
    _close(dele, want_del, 1e-4)
    _close(dh, want_dh, 1e-4)
    cpu_der = tbg.bitmap_gat_bwd_dst(plan.bits, None, None, *ins[:2], ins[2],
                                     0.2, *ins[3:], n_dst)
    cpu_del, cpu_dh = tbg.bitmap_gat_bwd_src(bits_t, None, None, *ins[:2],
                                             ins[2], 0.2, *ins[3:], n_src)
    _close(der.cpu(), cpu_der, 1e-4)
    _close(dele.cpu(), cpu_del, 1e-4)
    _close(dh.cpu(), cpu_dh, 1e-4)
    # rows without an edge: no gradient
    deg_dst = _expand_deg(plan.bits, n_src)[:n_dst]
    assert not der[torch.from_numpy(deg_dst == 0).to(card)].any()
    deg_src = _expand_deg(bits_t, n_dst)[:n_src]
    assert not dh[torch.from_numpy(deg_src == 0).to(card)].any()


def _expand_deg(bits, n_cols):
    return unpack_host(bits.numpy())[:, :n_cols].sum(1)


def test_edge_cases_cover_every_switch_case():
    assert sorted(tbg._passes(h, o)[:2] for h, o in EDGE_CASES) == sorted(
        SWITCH_CASES)
    assert sorted(SWITCH_CASES) == sorted(
        [(1, 8), (2, 8), (4, 8), (8, 8), (1, 16), (2, 16), (4, 16), (1, 32),
         (2, 32), (1, 64)])


@pytest.fixture(scope="module")
def edge_case_graph():
    from chip_smoke import edge_case_plan

    return edge_case_plan("cpu")


# (heads, odim) giving each (nh, nf) case of B4's and B5's switch: (1, 8),
# (2, 8), (4, 8), (8, 8) over two blocks of heads, (1, 16), (2, 16), (4, 16)
# over two, (1, 32), (2, 32), (1, 64) in three feature walks; and layer 1's
# H = 1, O = 41
@pytest.mark.parametrize("heads,odim", EDGE_CASES)
def test_bitmap_gat_bwd_edge_cases(card, edge_case_graph, heads, odim):
    """B4 and B5's walks at their edges (chip_smoke.py's
    ``edge_case_plan``: a full row each way, empty rows both ways), every
    (nh, nf) case of the switch, against the plain versions at B3's
    tolerance; rows without an edge get exact zeros."""
    from chip_smoke import EDGE_N_DST, EDGE_N_SRC

    plan, rel = edge_case_graph
    deg_dst = _expand_deg(plan.bits, EDGE_N_SRC)[:EDGE_N_DST]
    deg_src = _expand_deg(plan.bits_rev, EDGE_N_DST)[:EDGE_N_SRC]
    assert deg_dst[7] == EDGE_N_SRC - 100 and deg_src[9] == EDGE_N_DST - 100
    assert (deg_dst == 0).sum() == 100 and (deg_src == 0).sum() == 100
    el, er, h, lse, c, dz = (x.to(card) for x in _bwd_inputs(
        plan, heads, odim, heads * 10 + odim))
    bits, bits_t = plan.bits.to(card), plan.bits_rev.to(card)
    csc, csr = _index(rel, card)
    der = tbg.bitmap_gat_bwd_dst(bits, *csc, el, er, h, 0.2, lse, c, dz,
                                 EDGE_N_DST)
    dele, dh = tbg.bitmap_gat_bwd_src(bits_t, *csr, el, er, h, 0.2, lse, c,
                                      dz, EDGE_N_SRC)
    torch.cuda.synchronize()
    _close(der, tbg.gat_bwd_dst_plain(bits[:EDGE_N_DST], el, er, h, 0.2, lse,
                                      c, dz), 1e-4)
    want_del, want_dh = tbg.gat_bwd_src_plain(bits_t[:EDGE_N_SRC], el, er, h,
                                              0.2, lse, c, dz)
    _close(dele, want_del, 1e-4)
    _close(dh, want_dh, 1e-4)
    assert not der[torch.from_numpy(deg_dst == 0).to(card)].any()
    empty = torch.from_numpy(deg_src == 0).to(card)
    assert not dele[empty].any() and not dh[empty].any()


@pytest.mark.parametrize("heads,odim", FWD_CASES)
def test_bitmap_gat_bwd_dst_degree_extremes(card, heads, odim):
    """B4 over a CSC of in-degrees 0, 1, 31, 32, 33, around 64, 128 and
    256, 1,000 and more and a full row, with sink indices to be skipped
    (chip_smoke.py's ``fwd_edge_case_csc``, B3's edge cases), every (nh,
    nf) case and layer 1's H = 1, O = 41, against its plain version over
    the bits at B3's tolerance; rows without a real edge get der = 0."""
    from chip_smoke import FWD_N_DST, fwd_edge_case_csc

    plan, csc, deg = fwd_edge_case_csc(card)
    plan = plan.to("cpu")
    el, er, h, lse, c, dz = (x.to(card) for x in _bwd_inputs(
        plan, heads, odim, heads * 100 + odim))
    bits = plan.bits.to(card)
    before = _kernels.launch_counts["bitmap_gat_bwd_dst"]
    der = tbg.bitmap_gat_bwd_dst(bits, *csc, el, er, h, 0.2, lse, c, dz,
                                 FWD_N_DST)
    torch.cuda.synchronize()
    assert _kernels.launch_counts["bitmap_gat_bwd_dst"] == before + 1
    _close(der, tbg.gat_bwd_dst_plain(bits[:FWD_N_DST], el, er, h, 0.2, lse,
                                      c, dz), 1e-4)
    empty = deg == 0
    assert int(empty.sum()) >= 100 and bool(empty[25])
    assert not der[empty].any()


@pytest.mark.parametrize("heads,odim", FWD_CASES)
def test_bitmap_gat_bwd_src_degree_extremes(card, heads, odim):
    """B5 over a CSR of out-degrees 0, 1, 31, 32, 33, around 64, 128 and
    256, 1,000 and more and a full row, with sink indices to be skipped
    (chip_smoke.py's ``bwd_edge_case_csr``, the transpose of B4's graph),
    every (nh, nf) case and H = 1, O = 41, against its plain version over
    the transpose bitmap at B3's tolerance; rows without a real edge get
    del = dh = 0."""
    from chip_smoke import FWD_N_DST, bwd_edge_case_csr

    plan, csr, deg = bwd_edge_case_csr(card)
    plan = plan.to("cpu")
    el, er, h, lse, c, dz = (x.to(card) for x in _bwd_inputs(
        plan, heads, odim, heads * 100 + odim + 1))
    bits_t = plan.bits_rev.to(card)
    before = _kernels.launch_counts["bitmap_gat_bwd_src"]
    dele, dh = tbg.bitmap_gat_bwd_src(bits_t, *csr, el, er, h, 0.2, lse, c,
                                      dz, FWD_N_DST)
    torch.cuda.synchronize()
    assert _kernels.launch_counts["bitmap_gat_bwd_src"] == before + 1
    want_del, want_dh = tbg.gat_bwd_src_plain(bits_t[:FWD_N_DST], el, er, h,
                                              0.2, lse, c, dz)
    _close(dele, want_del, 1e-4)
    _close(dh, want_dh, 1e-4)
    empty = deg == 0
    assert int(empty.sum()) >= 100 and bool(empty[25])
    assert not dele[empty].any() and not dh[empty].any()


@pytest.mark.parametrize("nh", [8, 4, 2, 1])
def test_bitmap_gat_bwd_src_head_passes(card, bitmap_plans, bitmap_rel, nh):
    """B5 at the Reddit GAT's layer-0 shape (H = 8, O = 8) with its heads in
    passes of ``nh`` (the private launcher; chip_smoke.py times 8 against
    4) against its plain version at B3's tolerance."""
    plan = bitmap_plans[0]
    ins = _bwd_inputs(plan, 8, 8, 88)
    el, er, h, lse, c, dz = (x.to(card) for x in ins)
    _, csr = _index(bitmap_rel, card)
    bits_t = plan.bits_rev.to(card)
    tbg._check_bwd("CSR", bits_t, *csr, el, h, dz,
                   (("er", er, N_DST), ("lse", lse, N_DST), ("c", c, N_DST)),
                   N_SRC, N_DST)
    dele, dh = tbg._launch_bwd_src(*csr, el, er, h, 0.2, lse, c, dz, N_SRC,
                                   nh)
    torch.cuda.synchronize()
    want_del, want_dh = tbg.gat_bwd_src_plain(bits_t[:N_SRC], el, er, h, 0.2,
                                              lse, c, dz)
    _close(dele, want_del, 1e-4)
    _close(dh, want_dh, 1e-4)


def test_bitmap_gat_bwd_rejects_wrong_inputs(card, bitmap_plans, bitmap_rel):
    plan, _ = bitmap_plans
    el, er, h, lse, c, dz = (x.to(card) for x in _bwd_inputs(plan, 2, 4, 1))
    bits, bits_t = plan.bits.to(card), plan.bits_rev.to(card)
    csc, csr = _index(bitmap_rel, card)
    with pytest.raises(ValueError, match="bf16"):
        tbg.bitmap_gat_bwd_dst(bits, *csc, el, er, h.float(), 0.2, lse, c,
                               dz)
    with pytest.raises(ValueError, match="dz must be"):
        tbg.bitmap_gat_bwd_src(bits_t, *csr, el, er, h, 0.2, lse, c,
                               dz.double())
    for fn, b, idx in ((tbg.bitmap_gat_bwd_dst, bits, csc),
                       (tbg.bitmap_gat_bwd_src, bits_t, csr)):
        with pytest.raises(ValueError, match="bf16"):
            fn(b, *idx, el, er, h, 0.2, lse, c, dz.float())
    with pytest.raises(ValueError, match="lse must be"):
        tbg.bitmap_gat_bwd_dst(bits, *csc, el, er, h, 0.2, lse[:10], c, dz,
                               N_DST)
    # the kernels walk the relation's index: on the card it must be there,
    # int32 on the card (no fallback to the bits, no conversion)
    before = dict(_kernels.launch_counts)
    for fn, b, idx, n, what in (
            (tbg.bitmap_gat_bwd_dst, bits, csc, N_DST, "CSC"),
            (tbg.bitmap_gat_bwd_src, bits_t, csr, N_SRC, "CSR")):
        for bad, match in (((None, None), "indptr must be"),
                           ((idx[0], None), "indices must be"),
                           ((idx[0].long(), idx[1]), "indptr must be"),
                           ((idx[0], idx[1].long()), "indices must be"),
                           ((idx[0].cpu(), idx[1]), "indptr must be"),
                           ((idx[0], idx[1].cpu()), "indices must be"),
                           ((idx[0][:-1], idx[1]), "entries")):
            with pytest.raises(ValueError, match=match) as err:
                fn(b, *bad, el, er, h, 0.2, lse, c, dz, n)
            if match != "entries":
                assert f"the relation's {what}" in str(err.value)
    assert dict(_kernels.launch_counts) == before


def test_bitmap_gat_backward_needs_the_relation_on_card(card, bitmap_plans,
                                                        bitmap_rel):
    """``bitmap_gat`` without the relation has no CSC or CSR for the card's
    kernels: its forward raises (B3), and nothing falls back to the bits.
    With the relation a backward launches B4 and B5 once each."""
    plan = bitmap_plans[0].to(card)
    el = torch.ones(N_SRC, 2, device=card, requires_grad=True)
    er = torch.ones(N_DST, 2, device=card, requires_grad=True)
    h = torch.ones(N_SRC, 2, 4, device=card, requires_grad=True)
    with pytest.raises(ValueError, match="the relation's CSC"):
        tbg.bitmap_gat(0.2, plan, el, er, h)
    before = dict(_kernels.launch_counts)
    tbg.bitmap_gat(0.2, plan, el, er, h, bitmap_rel.to(card)).sum().backward()
    torch.cuda.synchronize()
    for name in ("bitmap_gat_bwd_dst", "bitmap_gat_bwd_src"):
        assert _kernels.launch_counts[name] == before[name] + 1


def test_spmm_backwards_launch_b2_and_b1(card, bitmap_plans, bitmap_rel):
    """B2 over the relation's CSR (the plain version over ``bits_rev``) and
    the hub backward (B1 over the reverse shells) on the card against the
    same backward on the CPU, one launch each way. The bitmap: the same f32
    terms in another order (rtol 1e-5, atol 1e-5 * max|ref|). The hub: bf16
    products and f32 sums in another order, rtol = atol = 1e-4."""
    plan, _ = bitmap_plans
    rng = np.random.default_rng(12)
    x = torch.from_numpy(rng.normal(size=(N_SRC, 16)).astype(np.float32))
    dz = torch.from_numpy(rng.normal(size=(N_DST, 16)).astype(np.float32))
    grads = []
    for p, r, dev in ((plan, bitmap_rel, "cpu"),
                      (plan.to(card), bitmap_rel.to(card), card)):
        xx = x.detach().clone().to(dev).requires_grad_()
        before = _kernels.launch_counts["bitmap_spmm"]
        (bitmap_copy_u_sum(p, xx, r) * dz.to(dev)).sum().backward()
        grads.append(xx.grad)
    torch.cuda.synchronize()
    assert _kernels.launch_counts["bitmap_spmm"] == before + 2
    _close(grads[1].cpu(), grads[0], 1e-5)

    w = 1.0 / np.arange(1, 6001)
    src = rng.choice(6000, 48000, p=w / w.sum())
    dst = rng.choice(6000, 48000, p=(w ** 0.7) / (w ** 0.7).sum())
    rel = dt.graph((src, dst), num_nodes=6000, device="cpu")._relation()
    hub = build_hub_plan(rel, 64, "int8")
    assert hub.res_src is not None and hub.unrank_src is not None
    x = torch.from_numpy(rng.normal(size=(6000, 64)).astype(np.float32))
    dz = torch.from_numpy(rng.normal(size=(6000, 64)).astype(np.float32))
    grads = []
    for p, dev in ((hub, "cpu"), (hub.to(card), card)):
        xx = x.detach().clone().to(dev).requires_grad_()
        before = _kernels.launch_counts["shell_prefix_sum"]
        (hub_copy_u_sum(p, xx) * dz.to(dev)).sum().backward()
        grads.append(xx.grad)
    torch.cuda.synchronize()
    assert _kernels.launch_counts["shell_prefix_sum"] == before + 2
    torch.testing.assert_close(grads[1].cpu(), grads[0], rtol=1e-4,
                               atol=1e-4)


def _step_graphs(card, dense):
    rng = np.random.default_rng(14)
    n = 3000
    if dense:  # symmetric with self-loops: the bitmap route
        src, dst = rng.integers(0, n, 40000), rng.integers(0, n, 40000)
        src, dst = (np.concatenate([src, dst, np.arange(n)]),
                    np.concatenate([dst, src, np.arange(n)]))
        flat = np.unique(dst * n + src)
        g = dt.graph((flat % n, flat // n), num_nodes=n,
                     device=card).with_spmm_plans(num_hubs=128,
                                                  dense_attn=False)
        assert g._relation().bitmap_plan is not None
    else:  # zipf sources, reordered: the hub route
        w = 1.0 / np.arange(1, n + 1)
        src = rng.choice(n, 30000, p=w / w.sum())
        g, _ = dt.transforms.reorder_for_spmm(
            dt.graph((src, rng.integers(0, n, 30000)), num_nodes=n,
                     device=card), num_hubs=128, precision="int8")
        assert g._relation().bitmap_plan is None
    return g, g.to("cpu"), rng


@pytest.mark.parametrize("name,dense,make,counts", [
    ("GCN", True, lambda d: GCN(24, 16, 5, dropout=0.0, device=d),
     {"bitmap_spmm": 4}),
    ("GAT", True, lambda d: GAT(24, 8, 5, heads=4, feat_drop=0.0,
                                attn_drop=0.0, device=d),
     {"bitmap_gat_fwd": 2, "bitmap_gat_bwd_dst": 2,
      "bitmap_gat_bwd_src": 2}),
    ("GraphSAGE", False, lambda d: GraphSAGE(24, 32, 5, num_layers=3,
                                             dropout=0.0, device=d),
     {"shell_prefix_sum": 5}),
], ids=["GCN", "GAT", "GraphSAGE"])
def test_training_step_on_card_matches_cpu(card, name, dense, make, counts):
    """One training step (masked cross-entropy, backward) of each model on
    the card against the same step on the CPU, with the launches it makes:
    GCN 2 B2 forward + 2 backward (symmetric bitmap); GAT 2 each of B3, B4
    and B5; GraphSAGE 3 B1 forward + 2 backward (layer 0 aggregates the
    input, which needs no gradient). The card's f32 projections differ
    from the CPU's in the last bit, which can move a bf16 rounding of an
    aggregated row: gradients compared at rtol 0, atol 2**-8 * max|ref|."""
    g, g_cpu, rng = _step_graphs(card, dense)
    n = g.num_nodes()
    x = torch.from_numpy(rng.normal(size=(n, 24)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 5, n))
    mask = torch.from_numpy((rng.random(n) < 0.6).astype(np.float32))
    model = make(card).train()
    model_cpu = make("cpu").train()
    model_cpu.load_state_dict({k: v.cpu()
                               for k, v in model.state_dict().items()})
    _kernels.reset_launch_counts()
    for m, gg, dev in ((model, g, card), (model_cpu, g_cpu, "cpu")):
        logits = m(gg, x.to(dev))
        ce = torch.nn.functional.cross_entropy(logits, y.to(dev),
                                               reduction="none")
        ((ce * mask.to(dev)).sum() / mask.sum()).backward()
        if dev == card:
            torch.cuda.synchronize()
            got = {k: v for k, v in _kernels.launch_counts.items() if v}
            assert got == counts
    for (k, p), q in zip(model.named_parameters(), model_cpu.parameters()):
        ref = q.grad
        torch.testing.assert_close(p.grad.cpu(), ref, rtol=0,
                                   atol=2.0 ** -8 * ref.abs().max().item(),
                                   msg=k)


# ---------------------------------------------------------------------------
# B6 (hub_gather) and the per-edge GAT route
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("precision", ["highest", "bf16"])
@pytest.mark.parametrize("feat", [256, 40, 13])
def test_hub_gather_kernel_matches_plain(card, dtype, precision, feat):
    """Exact selections on both sides: equal to the bit. Random slots over
    [0, H] (the sentinel H included), a negative slot, and F = 13 (the
    one-value path); the table also as a view one element in, which is not
    16-byte aligned (the one-value path too)."""
    H, E = 512, 6144
    rng = np.random.default_rng(feat)
    table = torch.from_numpy(rng.normal(size=(H + 1, feat)).astype(
        np.float32)).to(dtype)
    slots = torch.from_numpy(rng.integers(0, H + 1, (E, 1)).astype(np.int32))
    slots[5, 0] = -3
    table_c = table.to(card)
    shifted = table_c.reshape(-1)[1:1 + H * feat].view(H, feat)
    for hub in (table_c[:H], shifted):
        before = _kernels.launch_counts["hub_gather"]
        out = hub_gather(hub, slots.to(card), precision=precision)
        torch.cuda.synchronize()
        assert _kernels.launch_counts["hub_gather"] == before + 1
        assert out.dtype == dtype and out.shape == (E, feat)
        want = _hub_gather_plain(hub.cpu(), slots, precision)
        assert torch.equal(out.cpu(), want)
        assert torch.equal(out, _hub_gather_plain(hub, slots.to(card),
                                                  precision))
        dead = (slots[:, 0] < 0) | (slots[:, 0] >= H)
        assert not out[dead.to(card)].any() and int(dead.sum()) > 0


def test_hub_gather_rejects_wrong_inputs(card):
    hub = torch.ones(256, 8, device=card)
    slots = torch.zeros(2048, 1, dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="int32"):
        hub_gather(hub, slots.long())
    with pytest.raises(ValueError, match="f32 or bf16"):
        hub_gather(hub.double(), slots)
    with pytest.raises(ValueError, match="2048"):
        hub_gather(hub, slots[:1000])


def test_hub_copy_u_sum_launches_b6(card):
    """The hub-cache g-SpMM on the card: one B6 launch per call, the exact
    ``copy_u_sum`` at rtol = atol = 2e-4 (``tests/test_pallas_hub.py``'s
    bound; the same f32 rows summed in another order)."""
    rng = np.random.default_rng(9)
    n, e = 6000, 48000
    w = 1.0 / np.arange(1, n + 1)
    src = rng.choice(n, e, p=w / w.sum())
    g = dt.graph((src, rng.integers(0, n, e)), num_nodes=n, device=card)
    x = torch.from_numpy(rng.normal(size=(n, 40)).astype(np.float32)).to(card)
    plan = HubPlan.build(g._relation(), 1024)
    assert plan.slots.is_cuda and 0.0 < plan.coverage < 1.0
    before = _kernels.launch_counts["hub_gather"]
    with torch.no_grad():
        out = hub_cache_copy_u_sum(g._relation(), x, plan=plan)
    torch.cuda.synchronize()
    assert _kernels.launch_counts["hub_gather"] == before + 1
    torch.testing.assert_close(out, dt.ops.copy_u_sum(g, x), rtol=2e-4,
                               atol=2e-4)
    with pytest.raises(RuntimeError, match="no gradient"):
        hub_cache_copy_u_sum(g._relation(), x.requires_grad_(), plan=plan)


def test_gatconv_edge_route_matches_bitmap_route(card):
    """On a 4,200-node graph: GATConv's per-edge route (an edge weight of
    ones, which changes nothing) against its bitmap route (B3) on the card,
    with weights and input exact in bf16 so that B3's rounding of the
    projection changes nothing: B3's tolerance, rtol = 1e-4 and
    atol = 1e-5 * max|ref|. The per-edge route launches no kernel."""
    rng = np.random.default_rng(15)
    n = 4200
    src, dst = rng.integers(0, n, 60000), rng.integers(0, n, 60000)
    flat = np.unique(np.concatenate([dst * n + src, np.arange(n) * (n + 1)]))
    g = dt.graph((flat % n, flat // n), num_nodes=n, device=card)
    g = g.with_spmm_plans(num_hubs=128, dense_attn=False)
    conv = GATConv(8, 16, 4, generator=torch.Generator().manual_seed(2),
                   device=card).eval()
    with torch.no_grad():
        conv.fc.weight.copy_(torch.from_numpy(
            rng.integers(-7, 8, tuple(conv.fc.weight.shape)) / 8.0))
    x = torch.from_numpy(rng.integers(-1, 2, (n, 8)).astype(np.float32))
    x = x.to(card)
    with torch.inference_mode():
        _kernels.reset_launch_counts()
        bitmap = conv(g, x)
        torch.cuda.synchronize()
        assert _kernels.launch_counts["bitmap_gat_fwd"] == 1
        _kernels.reset_launch_counts()
        edge = conv(g, x, edge_weight=torch.ones(g.num_edges(), device=card))
        torch.cuda.synchronize()
        assert not any(_kernels.launch_counts.values())
    torch.testing.assert_close(edge, bitmap, rtol=1e-4,
                               atol=1e-5 * bitmap.abs().max().item())


# ---------------------------------------------------------------------------
# minibatch training: host-sampled blocks and the on-device sampler
# ---------------------------------------------------------------------------


def _zipf_graph(n, e, seed, device):
    rng = np.random.default_rng(seed)
    w = 1.0 / np.arange(1, n + 1)
    return dt.graph((rng.choice(n, e, p=w / w.sum()), rng.integers(0, n, e)),
                    num_nodes=n, device=device)


def test_minibatch_step_on_card_matches_cpu(card):
    """One ``sage_minibatch`` step over host-sampled blocks on the card
    against the same blocks and weights on the CPU: loss, logits and every
    gradient at rtol 1e-4, atol 1e-5 * max|ref| (f32 throughout; sums in
    other orders). No hand kernel runs on this path."""
    from dgl_tpu_torch.base import NID
    from dgl_tpu_torch.dataloading import FixedShapeNeighborSampler

    g = _zipf_graph(3000, 20000, 21, card)
    sampler = FixedShapeNeighborSampler([4, 6], 128, seed=0, device=card)
    seeds = np.random.default_rng(1).permutation(3000)[:120]
    _, _, blocks = sampler.sample_blocks(g, seeds)
    rng = np.random.default_rng(2)
    feats = torch.from_numpy(rng.normal(size=(3000, 20)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, 7, 3000))
    model = GraphSAGE(20, 32, 7, num_layers=2, dropout=0.0,
                      generator=torch.Generator().manual_seed(0),
                      device=card)
    model_cpu = GraphSAGE(20, 32, 7, num_layers=2, dropout=0.0, device="cpu")
    model_cpu.load_state_dict({k: v.cpu()
                               for k, v in model.state_dict().items()})
    out = {}
    _kernels.reset_launch_counts()
    for m, bs, dev in ((model, blocks, card),
                       (model_cpu, [b.to("cpu") for b in blocks], "cpu")):
        x = (feats.to(dev)[bs[0].srcdata[NID]]
             * bs[0].srcdata["_mask"][:, None])
        y = labels.to(dev)[bs[-1].dstdata[NID]]
        w = bs[-1].dstdata["_mask"].to(torch.float32)
        logits = m(bs, x)
        ce = torch.nn.functional.cross_entropy(logits, y, reduction="none")
        loss = (ce * w).sum() / torch.clamp(w.sum(), min=1)
        loss.backward()
        out[dev] = (loss.detach().cpu(), logits.detach().cpu(),
                    [p.grad.cpu() for p in m.parameters()])
    torch.cuda.synchronize()
    assert not any(_kernels.launch_counts.values())
    for got, ref in zip(out[card][:2] + tuple(out[card][2]),
                        out["cpu"][:2] + tuple(out["cpu"][2])):
        torch.testing.assert_close(got, ref, rtol=1e-4,
                                   atol=1e-5 * ref.abs().max().item())


@pytest.mark.parametrize("mode", ["unique", "replace", "exact"])
def test_device_sampler_on_card(card, mode):
    """The on-device sampler on a CUDA generator: every unmasked pick is an
    in-neighbour of its node, rows of in-degree at most the fanout take
    all their neighbours in CSC order, masks are 0 past the degree and on
    masked seeds' subtrees."""
    from dgl_tpu_torch.sampling import (DeviceNeighborSampler,
                                        device_seed_batches)

    g = _zipf_graph(3000, 20000, 22, "cpu")
    rel = g._relation()
    ip, ix = rel.csc_indptr.numpy(), rel.csc_indices.numpy()
    gen = torch.Generator(device=card).manual_seed(0)
    ids, smask = device_seed_batches(gen, 3000, 256, device=card)
    assert sorted(ids[smask].tolist()) == list(range(3000))
    mfg = DeviceNeighborSampler([5, 8], mode=mode).sample(
        gen, rel.csc_indptr.to(card), rel.csc_indices.to(card), ids[-1],
        seed_mask=smask[-1])
    assert mfg.nbrs[0].is_cuda and mfg.nbrs[0].dtype == torch.int32
    for depth, fanout in enumerate([8, 5]):
        front = mfg.frontiers[depth].cpu().numpy()
        nbr = mfg.nbrs[depth].cpu().numpy()
        mask = mfg.masks[depth].cpu().numpy()
        live = (smask[-1].cpu().numpy() if depth == 0 else
                np.concatenate([smask[-1].cpu().numpy(),
                                mfg.masks[0].cpu().numpy().reshape(-1)]))
        assert not mask[~live].any()
        for r, v in enumerate(front):
            lo, hi = ip[v], ip[v + 1]
            assert set(nbr[r][mask[r]]) <= set(ix[lo:hi])
            if not live[r]:
                continue
            if hi - lo <= fanout:
                assert mask[r][:hi - lo].all() and not mask[r][hi - lo:].any()
                assert (nbr[r][:hi - lo] == ix[lo:hi]).all()
            elif mode != "unique":
                assert mask[r].all()
    edges = mfg.num_real_edges()
    assert edges.is_cuda and int(edges) == sum(int(m.sum())
                                               for m in mfg.masks)


def test_uniform_stride_survives_to_card(card):
    """A block's relation keeps its stride, degree bounds and frames when
    the block moves to the card and back."""
    from dgl_tpu_torch.base import NID
    from dgl_tpu_torch.dataloading import FixedShapeNeighborSampler

    g = _zipf_graph(500, 3000, 23, "cpu")
    _, _, blocks = FixedShapeNeighborSampler([3], 16, seed=0, device="cpu"
                                             ).sample_blocks(g, np.arange(16))
    b = blocks[0]
    for moved in (b.to(card), b.to(card).to("cpu")):
        r, r0 = moved._relation(), b._relation()
        assert (r.uniform_stride, r.max_in_degree) == (3, r0.max_in_degree)
        assert moved.is_block and moved.dstdata[NID].shape == (17,)
        x = torch.randn(b.num_src_nodes(), 4)
        torch.testing.assert_close(
            dt.ops.copy_u_mean(r, x.to(r.device)).cpu(),
            dt.ops.copy_u_mean(r0, x), rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# B1's weighted caller: shell_prefix_gspmm
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("plan_name", ["residual", "identity", "empty",
                                       "tiles"])
def test_gspmm_kernel_edge_cases(card, plan_name, dtype):
    """The weighted kernel against its plain version on chip_smoke.py's
    edge-case plans (``gspmm_edge_case_plans``): every op and broadcast of
    ``GSPMM_SHAPES``, ``div`` by a zero at edge 0, rows out in rank order
    and in node order (``gspmm_case_ranks``), levels ending at the
    kernel's tile edges (``tiles``). Exact, inf and NaN included: the same
    rounded messages added in the same order."""
    from chip_smoke import (GSPMM_OPS, GSPMM_SHAPES, gspmm_case,
                            gspmm_case_ranks, gspmm_edge_case_plans)
    from dgl_tpu_torch.ops.shell_prefix import (shell_prefix_gspmm,
                                                shell_prefix_gspmm_plain)

    plan = gspmm_edge_case_plans(card)[plan_name]
    for i, (u_feat, e_feat) in enumerate(GSPMM_SHAPES):
        for op in GSPMM_OPS:
            if (u_feat is None) != (op == "copy_rhs"):
                continue
            args, base = gspmm_case(plan, u_feat, e_feat, op,
                                    getattr(torch, dtype), i, card)
            for rank in gspmm_case_ranks(plan, card):
                before = _kernels.launch_counts["shell_prefix_gspmm"]
                got = shell_prefix_gspmm(*args, base=base, rank=rank)
                torch.cuda.synchronize()
                assert (_kernels.launch_counts["shell_prefix_gspmm"]
                        == before + 1)
                want = shell_prefix_gspmm_plain(*args, base=base, rank=rank)
                torch.testing.assert_close(got, want, rtol=0, atol=0,
                                           equal_nan=True)
                cpu_args = [a.cpu() if isinstance(a, torch.Tensor) else a
                            for a in args]
                cpu = shell_prefix_gspmm_plain(
                    *cpu_args, base=None if base is None else base.cpu(),
                    rank=None if rank is None else rank.cpu())
                torch.testing.assert_close(got.cpu(), cpu, rtol=1e-6,
                                           atol=1e-6, equal_nan=True)


def test_gspmm_kernel_rejects_wrong_inputs(card):
    from chip_smoke import gspmm_case, gspmm_edge_case_plans
    from dgl_tpu_torch.ops.shell_prefix import shell_prefix_gspmm

    plan = gspmm_edge_case_plans(card)["residual"]
    (op, lhs, rhs, *rest), base = gspmm_case(plan, (2, 4), (2, 1), "mul",
                                             torch.float32, 0, card)
    n, e = lhs.shape[0], rhs.shape[0]
    # each operand's non-broadcast dims must be one contiguous run
    with pytest.raises(ValueError, match="unsupported broadcast"):
        shell_prefix_gspmm("mul", torch.ones(n, 2, 1, 4, device=card),
                           torch.ones(e, 1, 3, 1, device=card), *rest)
    with pytest.raises(ValueError, match="unsupported broadcast"):
        shell_prefix_gspmm("mul", torch.ones(n, 2, 3, 4, device=card),
                           torch.ones(e, 2, 1, 4, device=card), *rest)
    with pytest.raises(ValueError, match="bf16 or f32"):
        shell_prefix_gspmm("mul", lhs.half(), rhs.half(), *rest)
    with pytest.raises(ValueError, match="one type"):
        shell_prefix_gspmm("mul", lhs, rhs.to(torch.bfloat16), *rest)
    with pytest.raises(ValueError, match="int32"):
        shell_prefix_gspmm("mul", lhs, rhs, rest[0].long(), *rest[1:])
    with pytest.raises(ValueError, match="base"):
        shell_prefix_gspmm("mul", lhs, rhs, *rest,
                           base=torch.zeros(plan.num_dst, 8, device=card))
    # rank: an int32 permutation of the n_out rows on the tables' device
    rank = plan.rank_dst
    for bad, match in ((rank.cpu(), "device"), (rank.long(), "int32"),
                       (rank[:-1], "n_out"),
                       (torch.zeros_like(rank), "permutation")):
        with pytest.raises(ValueError, match=match):
            shell_prefix_gspmm("mul", lhs, rhs, *rest, rank=bad)
    # at most 32 levels: no fallback above the kernel's level table
    flat = torch.zeros(33 * 512, dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="SHELL_CAP"):
        shell_prefix_gspmm("mul", lhs, rhs, flat, flat, [512] * 33,
                           [1] * 33, plan.num_dst)


def test_shell_gspmm_sum_backward_launches_the_kernel(card):
    """``u_mul_e_sum`` over a weighted plan on the card: one launch
    forward, one backward (the source gradient over the reverse shells;
    the edge gradient is gathers), values and gradients as on the CPU."""
    from chip_smoke import gspmm_edge_case_plans

    rng = np.random.default_rng(3)
    n, e = 300, 4000
    w = 1.0 / np.arange(1, n + 1)
    src = rng.choice(n, e, p=w / w.sum())
    dst = rng.choice(n, e, p=w[::-1] / w.sum())
    u = rng.normal(size=(n, 2, 4)).astype(np.float32)
    ew = rng.normal(size=(e, 2, 1)).astype(np.float32)
    dz = rng.normal(size=(n, 2, 4)).astype(np.float32)
    outs = {}
    for dev in ("cpu", card):
        g = dt.graph((src, dst), num_nodes=n, device=dev).with_spmm_plans(
            num_hubs=16, weighted=True)
        ut = torch.from_numpy(u).to(dev).requires_grad_()
        et = torch.from_numpy(ew).to(dev).requires_grad_()
        _kernels.reset_launch_counts()
        out = dt.ops.u_mul_e_sum(g, ut, et)
        assert _kernels.launch_counts["shell_prefix_gspmm"] == (
            1 if dev == card else 0)
        out.backward(torch.from_numpy(dz).to(dev))
        if dev == card:
            torch.cuda.synchronize()
            assert _kernels.launch_counts["shell_prefix_gspmm"] == 2
            assert not any(v for k, v in _kernels.launch_counts.items()
                           if k != "shell_prefix_gspmm")
        outs[str(dev)] = [t.detach().cpu() for t in (out, ut.grad, et.grad)]
    for a, b in zip(outs[str(card)], outs["cpu"]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    assert gspmm_edge_case_plans("cpu")["empty"].fwd.level_rows == []


def test_weighted_routes_on_card_match_cpu(card):
    """GAT over the fused route (a weighted plan, no dense mask) and over
    the dense route (a small graph), and the weighted GCN layer, on the
    card against the same modules on the CPU; no hand kernel launches on
    the GAT routes."""
    from dgl_tpu_torch.nn import EdgeWeightNorm, GraphConv

    rng = np.random.default_rng(5)
    n = 400
    src, dst = rng.integers(0, n, 4000), rng.integers(0, n, 4000)
    src = np.concatenate([src, np.arange(n)])
    dst = np.concatenate([dst, np.arange(n)])
    x = rng.normal(size=(n, 12)).astype(np.float32)
    w = (rng.random(src.shape[0]) + 0.5).astype(np.float32)
    res = {}
    for dev in ("cpu", card):
        g = dt.graph((src, dst), num_nodes=n, device=dev)
        gf = g.with_spmm_plans(num_hubs=16, weighted=True, gather_dtype="f32",
                               dense_attn=False, bitmap=False)
        gd = g.with_spmm_plans(num_hubs=16, dense_attn_max_cells=10**6,
                               bitmap=False)
        gat = GAT(12, 4, 3, heads=2, generator=torch.Generator().manual_seed(
            0), device=dev).eval()
        conv = GraphConv(12, 6, norm="none", generator=torch.Generator(
        ).manual_seed(1), device=dev)
        xt = torch.from_numpy(x).to(dev)
        _kernels.reset_launch_counts()
        with torch.no_grad():
            fused, dense = gat(gf, xt), gat(gd, xt)
        assert not any(_kernels.launch_counts.values())
        with torch.no_grad():
            gcn = conv(gf, xt, edge_weight=EdgeWeightNorm("both")(
                gf, torch.from_numpy(w).to(dev)))
        res[str(dev)] = [t.cpu() for t in (fused, dense, gcn)]
    (fused, dense, gcn), (fused_c, dense_c, gcn_c) = res[str(card)], res["cpu"]
    torch.testing.assert_close(fused, fused_c, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(gcn, gcn_c, rtol=1e-4, atol=1e-4)
    # the dense route in bf16: an exp that differs in the last bit may
    # round to the neighbouring bf16 value
    torch.testing.assert_close(dense, dense_c, rtol=0,
                               atol=2.0 ** -8 * dense_c.abs().max().item())


@pytest.mark.parametrize("num_etypes", [3, 40])
def test_hgtconv_on_card_matches_cpu(card, num_etypes):
    """HGTConv with ``use_norm`` on the card against the same layer on the
    CPU: output and every gradient at rtol = 1e-4; no hand kernel. Three
    relations take ``relation_rows``' row route, 40 its per-edge
    ``gather_mm`` route."""
    from dgl_tpu_torch.nn import HGTConv

    rng = np.random.default_rng(8)
    n, e = 300, 2500
    src = np.concatenate([rng.integers(0, n, e), np.arange(n)])
    dst = np.concatenate([rng.integers(0, n, e), np.arange(n)])
    x = rng.normal(size=(n, 16)).astype(np.float32)
    ntype = rng.integers(0, 3, n)
    etype = rng.integers(0, num_etypes, src.shape[0])
    cot = rng.normal(size=(n, 16)).astype(np.float32)
    res = {}
    for dev in ("cpu", card):
        g = dt.graph((src, dst), num_nodes=n, device=dev)
        conv = HGTConv(16, 4, 4, 3, num_etypes, use_norm=True,
                       generator=torch.Generator().manual_seed(0),
                       device=dev).eval()
        xt = torch.from_numpy(x).to(dev).requires_grad_()
        _kernels.reset_launch_counts()
        out = conv(g, xt, torch.from_numpy(ntype).to(dev),
                   torch.from_numpy(etype).to(dev))
        (out * torch.from_numpy(cot).to(dev)).sum().backward()
        assert not any(_kernels.launch_counts.values())
        res[str(dev)] = [out.detach().cpu(), xt.grad.cpu()] + [
            p.grad.cpu() for p in conv.parameters()]
    for a, b in zip(res[str(card)], res["cpu"]):
        torch.testing.assert_close(a, b, rtol=1e-4,
                                   atol=1e-4 * b.abs().max().item())


@pytest.mark.parametrize("name,counts", [
    ("APPNPConv", {"shell_prefix_sum": (3, 3)}),
    ("GATv2Conv", {"shell_prefix_gspmm": (1, 1)}),
])
def test_planned_convs_launch_b1_and_b1w(card, name, counts):
    """APPNP (k = 3: one ``copy_u`` sum a hop, through the hub plan's cold
    tail, B1) and GATv2 (``u_mul_e`` of (E, H, 1) attention against
    (N, H, O) rows, through the shell plan, B1w) on a planned graph: the
    launches of the forward and of the backward, (forward, backward) in
    ``counts``, none of any other kernel; values and gradients as on the
    CPU, where the wrappers run the plain versions (f32 gathers on the
    shell plan, so the kernel sums the very values of the plain version;
    APPNP computes no table, so both sides round the same rows)."""
    from dgl_tpu_torch.nn import APPNPConv, GATv2Conv

    rng = np.random.default_rng(9)
    n, e = 500, 6000
    w = 1.0 / np.arange(1, n + 1)
    src = np.concatenate([rng.choice(n, e, p=w / w.sum()), np.arange(n)])
    dst = np.concatenate([rng.integers(0, n, e), np.arange(n)])
    x = rng.normal(size=(n, 24)).astype(np.float32)
    res = {}
    for dev in ("cpu", card):
        g = dt.graph((src, dst), num_nodes=n, device=dev).with_spmm_plans(
            num_hubs=32, weighted=True, gather_dtype="f32", bitmap=False,
            dense_attn=False)
        conv = (APPNPConv(k=3) if name == "APPNPConv" else GATv2Conv(
            24, 8, 3, generator=torch.Generator().manual_seed(0),
            device=dev)).eval()
        xt = torch.from_numpy(x).to(dev).requires_grad_()
        _kernels.reset_launch_counts()
        out = conv(g, xt)
        fwd = dict(_kernels.launch_counts)
        _kernels.reset_launch_counts()
        out.sum().backward()
        bwd = dict(_kernels.launch_counts)
        if dev == card:
            torch.cuda.synchronize()
            for k in fwd:
                f, b = counts.get(k, (0, 0))
                assert (fwd[k], bwd[k]) == (f, b), (k, fwd[k], bwd[k])
        res[str(dev)] = [out.detach().cpu(), xt.grad.cpu()] + [
            p.grad.cpu() for p in conv.parameters()]
    for a, b in zip(res[str(card)], res["cpu"]):
        torch.testing.assert_close(a, b, rtol=1e-4,
                                   atol=1e-4 * b.abs().max().item())


# ---------------------------------------------------------------------------
# SAGEConv's gcn aggregator and LabelPropagation over a hub plan
# ---------------------------------------------------------------------------


def test_sage_gcn_and_label_propagation_launch_b1(card, monkeypatch):
    """GraphSAGE 16-32-32-8 with the ``gcn`` aggregator over a hub plan
    (``reorder_for_spmm(num_hubs=64, precision="int8")``) on the card: 3
    B1 launches a forward and 5 a training step (layer 0's input needs no
    gradient), none of any other kernel; ``LabelPropagation(k=4)``: 4
    launches. Each output against the same call with B1's plain version in
    place of the kernel, on the same card (they sum the same bf16 rows in
    the same order): rtol = atol = 1e-5 (the kernel matches its plain
    version exactly; the rest is the same operations)."""
    from dgl_tpu_torch.nn import LabelPropagation
    from dgl_tpu_torch.ops import shell_prefix

    g = _zipf_graph(3000, 30000, 5, card)
    gp, _ = dt.transforms.reorder_for_spmm(g, num_hubs=64, precision="int8")
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.normal(size=(3000, 16)).astype(
        np.float32)).to(card)
    y = torch.from_numpy(rng.integers(0, 8, 3000)).to(card)
    mask = torch.from_numpy(rng.random(3000) < 0.1).to(card)
    model = GraphSAGE(16, 32, 8, num_layers=3, aggregator_type="gcn",
                      dropout=0.0, generator=torch.Generator().manual_seed(0),
                      device=card)
    lp = LabelPropagation(k=4)

    def run():
        _kernels.reset_launch_counts()
        out = model(gp, x)
        fwd = dict(_kernels.launch_counts)
        _kernels.reset_launch_counts()
        torch.nn.functional.cross_entropy(out, y).backward()
        step = fwd["shell_prefix_sum"] + _kernels.launch_counts[
            "shell_prefix_sum"]
        grads = [p.grad.clone() for p in model.parameters()]
        model.zero_grad(set_to_none=True)
        _kernels.reset_launch_counts()
        labels = lp(gp, y, mask)
        torch.cuda.synchronize()
        return fwd, step, dict(_kernels.launch_counts), [
            out.detach(), labels] + grads

    fwd, step, lp_launches, got = run()
    assert fwd == {**{k: 0 for k in fwd}, "shell_prefix_sum": 3}
    assert step == 5
    assert lp_launches == {**{k: 0 for k in lp_launches},
                           "shell_prefix_sum": 4}
    monkeypatch.setattr(hub_spmm, "shell_prefix_sum",
                        lambda t, idx, rows, n, base=None, levels=None:
                        shell_prefix.shell_prefix_sum_plain(t, idx, rows, n,
                                                            base))
    _f, _s, _l, ref = run()
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_sparse_gcn_on_card_matches_cpu_and_graphconv(card):
    """Phase ``sparse_gcn``'s core checks at a small size: the sparse-API
    GCN's matrix (indices exact, values 1e-5), output and gradients on the
    card against the CPU and against ``GraphConv(norm="both")`` on the
    graph plus self-loops (rtol = 1e-4, atol = 1e-4 * max|ref|: the same
    f32 sums in another order), no hand kernel launched; every sparse op
    of the phase, the card against the CPU (rtol = 1e-5)."""
    import chip_smoke as cs
    from dgl_tpu_torch.sparse import SparseMatrix

    g = _zipf_graph(3000, 20000, 8, card)
    dims = (16, 32, 32, 5)
    out, grads, pattern = {}, {}, None
    for dev, gg in (("cuda", g), ("cpu", g.to("cpu"))):
        gs, A = cs.sparse_gcn_matrix(gg)
        params = cs.sparse_gcn_params(dims, 0, dev)
        x = torch.from_numpy(np.random.default_rng(1).normal(
            size=(3000, 16)).astype(np.float32)).to(dev)
        _kernels.reset_launch_counts()
        # every pass on the card pass's ReLU pattern (chip_smoke's
        # check_grads explains why)
        with cs.relu_pattern(pattern and [m.cpu() for m in pattern]) as seen:
            out[dev] = cs.sparse_gcn_forward(A, x, params)
        (out[dev] ** 2).sum().backward()
        if dev == "cuda":
            assert not any(_kernels.launch_counts.values())
            A_card, pattern = A, seen
            convs = cs.graphconv_stack(params, dev)
            with cs.relu_pattern(pattern):
                ref = cs.graphconv_forward(convs, dt.add_self_loop(gs), x)
            (ref ** 2).sum().backward()
            cs.held_against(out[dev], ref, 1e-4, "vs GraphConv")
            for (w, b), conv in zip(params, convs):
                cs.held_against(w.grad, conv.weight.grad, 1e-4, "grad W")
                cs.held_against(b.grad, conv.bias.grad, 1e-4, "grad b")
        else:
            cs.same_matrix(A_card, A, "A_norm")
        grads[dev] = [t.grad for p in params for t in p]
    cs.held_against(out["cuda"], out["cpu"], 1e-4, "vs the CPU")
    for a, b in zip(grads["cuda"], grads["cpu"]):
        cs.held_against(a, b, 1e-4, "grad vs the CPU")
    on_card = cs.sparse_op_cases(A_card)
    on_cpu = cs.sparse_op_cases(cs.matrix_to(A_card, "cpu"))
    for name, fn in on_card.items():
        got, want = fn(), on_cpu[name]()
        if isinstance(got, SparseMatrix):
            cs.same_matrix(got, want, name)
        else:
            cs.held_against(got, want, 1e-5, name)


def test_gcn_recipe_on_card_launches_b1(card):
    """Phase ``gcn_recipe``'s count at a small size: the recipe's graph
    with ``with_spmm_plans(num_hubs=64, weighted=True)`` and GCN 16-32-32-5
    launch B1 3 times a forward and 5 a step (layer 0's input needs no
    gradient) and no other kernel; the output within the plan path's
    2e-2 of the graph without plans; and the recipe's transforms (at this
    size) give the CPU's graphs."""
    import chip_smoke as cs

    g = _zipf_graph(3000, 20000, 9, card)
    gr = dt.add_self_loop(dt.remove_self_loop(g))
    gp = gr.with_spmm_plans(num_hubs=64, weighted=True)
    x = torch.from_numpy(np.random.default_rng(2).normal(
        size=(3000, 16)).astype(np.float32)).to(card)
    model = GCN(16, 32, 5, num_layers=3, dropout=0.0,
                generator=torch.Generator().manual_seed(0), device=card)
    _kernels.reset_launch_counts()
    out = model(gp, x)
    fwd = dict(_kernels.launch_counts)
    out.square().sum().backward()
    torch.cuda.synchronize()
    assert fwd == {**{k: 0 for k in fwd}, "shell_prefix_sum": 3}
    assert dict(_kernels.launch_counts) == {
        **{k: 0 for k in fwd}, "shell_prefix_sum": 5}
    cs.held_against(out, model(gr, x), 2e-2, "vs the graph without plans")
    g.ndata["x"] = x
    g_cpu = g.to("cpu")
    for name, fn in cs.recipe_transforms(3000, 20000).items():
        cs.same_result(fn(dt, g), fn(dt, g_cpu), name)


def test_batched_readout_on_card_matches_cpu(card):
    """Phase ``batched_readout``'s core checks at a small size: the GIN's
    logits and gradients on a batch of 8 molhiv-sized graphs against the
    CPU on the card pass's ReLU pattern (rtol = 1e-4), no hand kernel;
    the readouts on 256 graphs at
    rtol = 1e-5, ``unbatch``, ``slice_batch`` and ``pad_batch`` exact."""
    import chip_smoke as cs

    bg = dt.batch(cs.molhiv_graphs(8, 0, card))
    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=(bg.num_nodes(), cs.GIN_DIM)).astype(np.float32))
    outs, grads, pattern = {}, {}, None
    for dev in ("cuda", "cpu"):
        model = cs.gin_model(dev)
        _kernels.reset_launch_counts()
        with cs.relu_pattern(pattern and [m.cpu() for m in pattern]) as seen:
            outs[dev] = model(bg.to(dev), x.to(dev))
        pattern = pattern or seen
        outs[dev].square().sum().backward()
        grads[dev] = [p.grad for p in model.parameters()]
    assert not any(_kernels.launch_counts.values())
    cs.held_against(outs["cuda"], outs["cpu"], 1e-4, "GIN logits")
    for a, b in zip(grads["cuda"], grads["cpu"]):
        cs.held_against(a, b, 1e-4, "GIN grad")
    big_cpu = dt.batch(cs.molhiv_graphs(256, 5, "cpu"))
    big = big_cpu.to(card)
    g_card, on_card = cs.readout_cases(big)
    g_host, on_cpu = cs.readout_cases(big_cpu)
    for name, fn in on_card.items():
        got, want = fn(), on_cpu[name]()
        if isinstance(got, tuple):
            cs.held_against(got[0], want[0], 1e-5, name)
            cs.same_result(got[1], want[1], name)
        else:
            cs.held_against(got, want, 1e-5, name)
    parts = dt.unbatch(g_card)
    for a, b in zip(parts, dt.unbatch(g_host)):
        cs.same_graph_on(a, b, "unbatch")
    cs.same_graph_on(dt.slice_batch(g_card, 100, store_ids=True),
                     dt.slice_batch(g_host, 100, store_ids=True), "slice")
    shape = (260, big.num_nodes() + 10, big.num_edges() + 10)
    pc, mc = dt.pad_batch(parts, *shape)
    ph, mh = dt.pad_batch(dt.unbatch(g_host), *shape)
    cs.same_graph_on(pc, ph, "pad_batch")
    cs.same_result(mc, mh, "pad_batch mask")


def test_sign_diffusion_on_card_launches_b1(card):
    """``SIGNDiffusion(k=3)`` over a small hub plan: one B1 launch a hop
    for each op, every hop within the plan bound of the graph without
    plans, and B1 against its plain version on the hops' real tables."""
    import chip_smoke as cs

    rng = np.random.default_rng(0)
    n, e = 3000, 20000
    src = np.minimum(rng.zipf(1.5, e) - 1, n - 1)
    dst = rng.integers(0, n, e)
    gp, _ = dt.transforms.reorder_for_spmm(
        dt.graph((src, dst), num_nodes=n, device=card), num_hubs=64)
    g_plain = cs.strip_plans(gp)
    x = torch.from_numpy(rng.normal(size=(n, 32)).astype(np.float32))
    for g in (gp, g_plain):
        g.ndata["feat"] = x.to(card)
    for op in cs.SIGN_OPS:
        _kernels.reset_launch_counts()
        with torch.inference_mode(), cs.record_b1() as calls:
            hops = cs.sign_hops(gp, op)
        torch.cuda.synchronize()
        cs.expect_no_other_launch(dict(_kernels.launch_counts),
                                  {"shell_prefix_sum": cs.SIGN_HOPS}, op)
        cs.b1_calls_exact(calls, op)
        with torch.inference_mode():
            for a, b in zip(hops, cs.sign_hops(g_plain, op)):
                cs.held_against(a, b, 2e-2, f"{op} vs no plan")


def test_farthest_point_sampler_on_card_matches_cpu(card):
    from dgl_tpu_torch.geometry import farthest_point_sampler

    pos = torch.from_numpy(np.random.default_rng(1).random(
        (4, 700, 3)).astype(np.float32))
    for start in (None, 5):
        got = farthest_point_sampler(pos.to(card), 300, start)
        assert got.device.type == "cuda"
        assert torch.equal(got.cpu(), farthest_point_sampler(pos, 300,
                                                             start))


def test_knn_graph_on_card_matches_cpu(card):
    """Edges equal to the CPU's but for float32 near-ties
    (``chip_smoke.knn_near_ties``); on integer points, where every
    distance is exact, identical, ties to the lower index."""
    import chip_smoke as cs

    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.random((900, 3)).astype(np.float32))
    for dist in ("euclidean", "cosine"):
        got = dt.knn_graph(x.to(card), 12, dist=dist)
        want = dt.knn_graph(x, 12, dist=dist)
        assert torch.equal(got.edges()[1].cpu(), want.edges()[1])
        if dist == "euclidean":
            cs.knn_near_ties(got.edges()[0], want.edges()[0], x, 12)
    grid = torch.from_numpy(rng.integers(0, 5, (400, 2)).astype(np.float32))
    got = dt.knn_graph(grid.to(card), 9)
    cs.same_graph_on(got, dt.knn_graph(grid, 9), "integer points")
    seg = dt.segmented_knn_graph(x.to(card), 7, [300, 600])
    assert torch.equal(seg.edges()[1].cpu(), dt.segmented_knn_graph(
        x, 7, [300, 600]).edges()[1])


def _sampler_graph(card, n=3000, e=30000, seed=11):
    """A zipf graph on the card with features, labels and edge weights."""
    rng = np.random.default_rng(seed)
    w = 1.0 / np.arange(1, n + 1)
    g = dt.graph((rng.choice(n, e, p=w / w.sum()), rng.integers(0, n, e)),
                 num_nodes=n, device=card)
    g.ndata["feat"] = torch.from_numpy(rng.normal(size=(n, 8)).astype(
        np.float32)).to(card)
    g.ndata["label"] = torch.from_numpy(rng.integers(0, 4, n)).to(card)
    g.edata["w"] = torch.from_numpy(rng.random(e).astype(np.float32)).to(
        card)
    return g


@pytest.mark.parametrize("name", ["neighbor", "labor", "fixed_prob",
                                  "edge_prediction", "hetero_fixed"])
def test_sampler_on_card_matches_cpu(card, name):
    """The host samplers pick the same edges for a graph on the card as
    for its copy on the CPU; the card's blocks lie on the card."""
    import chip_smoke as cs
    from dgl_tpu_torch import dataloading as dl

    g = _sampler_graph(card)
    seeds = np.random.default_rng(3).permutation(3000)[:128]
    makers = {
        "neighbor": lambda dev: dl.NeighborSampler([5, 5], prob="w",
                                                   seed=1),
        "labor": lambda dev: dl.LaborSampler([5, 5], importance_sampling=1,
                                             seed=1),
        "fixed_prob": lambda dev: dl.FixedShapeNeighborSampler(
            [4, 4], 128, prob="w", seed=1, device=dev),
        "edge_prediction": lambda dev: dl.as_edge_prediction_sampler(
            dl.NeighborSampler([4, 4], seed=1), exclude="self",
            negative_sampler=dl.Uniform(2, seed=1)),
    }
    if name == "hetero_fixed":
        src, dst = g.edges()
        hg = dt.heterograph({("a", "to", "b"): (src.cpu(), dst.cpu()),
                             ("b", "back", "a"): (dst.cpu(), src.cpu())},
                            {"a": 3000, "b": 3000}, device=card)
        fan = [{"to": 3, "back": 2}, {"to": 4, "back": 0}]
        got = dl.HeteroFixedShapeNeighborSampler(
            hg, fan, 128, seed_ntype="b", seed=1, device=card).sample_blocks(
                hg, seeds)
        want = dl.HeteroFixedShapeNeighborSampler(
            hg, fan, 128, seed_ntype="b", seed=1, device="cpu").sample_blocks(
                hg.to("cpu"), seeds)
    else:
        got = makers[name](card).sample(g, seeds)
        want = makers[name]("cpu").sample(g.to("cpu"), seeds)
    cs.same_result(got, want, name)
    assert got[-1][0].device.type == "cuda"


def test_dataloader_prefetch_thread_on_card(card):
    """The batches the prefetch thread moves to the card equal the ones
    sampled inline, and a training step over them runs."""
    import chip_smoke as cs
    from dgl_tpu_torch import dataloading as dl

    g = _sampler_graph(card)
    ids = torch.arange(0, 3000, 2)

    def loader(thread):
        return dl.DataLoader(g, ids, dl.NeighborSampler([4, 4], seed=2),
                             batch_size=256, shuffle=True, seed=3,
                             use_prefetch_thread=thread, device=card)

    threaded, inline = list(loader(True)), list(loader(False))
    assert len(threaded) == len(inline) == 6
    cs.same_result(threaded, inline, "thread vs inline")
    model = GraphSAGE(8, 16, 4, num_layers=2, dropout=0.0,
                      generator=torch.Generator().manual_seed(0),
                      device=card)
    _kernels.reset_launch_counts()
    for _, _, blocks in threaded:
        logits = model(blocks, blocks[0].srcdata["feat"])
        torch.nn.functional.cross_entropy(
            logits, blocks[-1].dstdata["label"]).backward()
    torch.cuda.synchronize()
    assert not any(_kernels.launch_counts.values())


def test_deepwalk_step_on_card_matches_cpu(card):
    """One DeepWalk batch (host draws, equal on both sides) and one SGD
    step: the loss and both tables' gradients against the CPU at
    rtol = 1e-5, atol = 1e-5 * max|ref|."""
    import chip_smoke as cs
    from dgl_tpu_torch.nn import DeepWalk

    g = _sampler_graph(card, n=500, e=4000)
    out = {}
    for dev, graph in ((card, g), ("cpu", g.to("cpu"))):
        model = DeepWalk(500, emb_dim=16, walk_length=10, window_size=3,
                         generator=torch.Generator().manual_seed(0),
                         device=dev)
        batch = model.sample_batch(graph, np.arange(0, 500, 5),
                                   np.random.default_rng(4))
        loss = model(*batch)
        loss.backward()
        out[str(dev)] = (batch, {"loss": loss.detach(), **{
            k: p.grad for k, p in model.named_parameters()}})
    cs.same_result(out[str(card)][0], out["cpu"][0], "DeepWalk batch")
    cs.held(out[str(card)][1], out["cpu"][1], 1e-5, "DeepWalk step")


def test_cluster_gcn_on_card_matches_cpu(card):
    """Phase ``cluster_gcn``'s checks at a small size: the partition of the
    card's graph equals the CPU copy's, a batch of parts is the CPU's
    subgraph, and one GraphSAGE step over it matches the CPU's (rtol =
    1e-4 on the card pass's ReLU pattern) with no kernel launched."""
    import chip_smoke as cs
    from dgl_tpu_torch.dataloading import ClusterGCNSampler
    from dgl_tpu_torch.distributed import metis_partition_assignment

    g = _zipf_graph(3000, 20000, 12, card)
    rng = np.random.default_rng(13)
    g.ndata["feat"] = torch.from_numpy(rng.normal(size=(3000, 16)).astype(
        np.float32)).to(card)
    g.ndata["label"] = torch.from_numpy(rng.integers(0, 5, 3000)).to(card)
    g.ndata["train_mask"] = torch.from_numpy(rng.random(3000) < 0.6).to(card)
    g_cpu = g.to("cpu")
    sampler = ClusterGCNSampler(g, 8)
    parts = np.empty(3000, np.int64)
    for p, ids in enumerate(sampler.part_nodes):
        parts[ids] = p
    assert np.array_equal(parts, metis_partition_assignment(g_cpu, 8))
    sg = sampler.sample(g, [1, 6])
    cs.same_result(sg, sampler.sample(g_cpu, [1, 6]), "parts 1 and 6")

    def make(dev):
        return GraphSAGE(16, 32, 5, num_layers=3,
                         generator=torch.Generator().manual_seed(0),
                         device=dev)

    _kernels.reset_launch_counts()
    cs.step_vs_cpu(make(card), lambda: make("cpu"), cs.cluster_loss, sg)
    assert not any(_kernels.launch_counts.values())


def test_partition_files_on_card_match_cpu(card):
    """``partition_graph`` of a graph on the card writes the CPU's files;
    ``load_partition`` puts the parts back on the card."""
    import chip_smoke as cs

    g = _zipf_graph(800, 5000, 14, card)
    card_files = cs.partition_files(dt, g, "card")
    cpu_files = cs.partition_files(dt, g.to("cpu"), "cpu")
    cs.same_result(card_files, cpu_files, "partition files")
    assert all(p.device.type == "cuda" for p in
               (sub.ndata["_new_id"] for sub in card_files[1]))


def test_gnnexplainer_on_card_launches_b1w(card):
    """Phase ``explain_gcn``'s count at a small size: every
    ``explain_graph`` epoch of the weighted GCN over
    ``with_spmm_plans(num_hubs=64, weighted=True)`` launches B1w
    ``EXPLAIN_EPOCH_LAUNCHES`` times (4 forward, 3 backward), the target
    pass 4; the masks lie in [0, 1]."""
    import chip_smoke as cs
    from dgl_tpu_torch.nn.explain import GNNExplainer

    g = _zipf_graph(3000, 20000, 15, card)
    gp = dt.add_self_loop(g).with_spmm_plans(num_hubs=64, weighted=True)
    x = torch.from_numpy(np.random.default_rng(16).normal(
        size=(3000, 16)).astype(np.float32)).to(card)
    model = cs.weighted_gcn((16, 32, 32, 5), 0.0, 0).to(card).eval()
    _kernels.reset_launch_counts()
    fm, em = GNNExplainer(cs.explain_gcn_fn(model), 3,
                          num_epochs=4).explain_graph(gp, x)
    torch.cuda.synchronize()
    assert dict(_kernels.launch_counts) == {
        **{k: 0 for k in _kernels.launch_counts},
        "shell_prefix_gspmm": 4 + 4 * cs.EXPLAIN_EPOCH_LAUNCHES}
    for m in (fm, em):
        assert m.min() >= 0 and m.max() <= 1


def test_explainers_on_card_match_cpu(card):
    """PGExplainer (the seed's noise on both devices), SubgraphX and
    GNNExplainer's ``explain_node`` on small inputs: the card against the
    CPU at rtol = 1e-4, the node sets exactly."""
    import chip_smoke as cs
    from dgl_tpu_torch.nn.explain import (GNNExplainer, PGExplainer,
                                          SubgraphX)

    graphs = cs.molhiv_graphs(4, 3, card)
    bg = dt.batch(graphs)
    x = torch.from_numpy(np.random.default_rng(17).normal(
        size=(bg.num_nodes(), cs.GIN_DIM)).astype(np.float32)).to(card)
    model = cs.gin_explain_model(card)
    model_cpu = cs.gin_explain_model("cpu")
    model_cpu.load_state_dict({k: v.cpu()
                               for k, v in model.state_dict().items()})
    out = {}
    for dev, m, graph, feat in ((card, model, bg, x),
                                ("cpu", model_cpu, bg.to("cpu"), x.cpu())):
        ex = PGExplainer(m, cs.GIN_DIM, epochs=5)
        loss = ex.train_step(graph, feat)
        probs, mask = ex.explain_graph(graph, feat)
        one = dt.unbatch(graph)[0]
        nodes, score = SubgraphX(lambda g, h: m(g, h)[0], num_rollouts=5,
                                 shapley_steps=5).explain_graph(
            one, feat[:one.num_nodes()])
        nid, sg, fm, em = GNNExplainer(
            lambda g, h, w: m(g, h, w)[0].sum(0, keepdim=True), 2,
            num_epochs=5).explain_node(3, graph, feat)
        out[str(dev)] = ({"loss": torch.tensor(loss), "probs": probs,
                          "mask": mask, "score": torch.tensor(score),
                          "fm": fm, "em": em}, nodes, nid)
    got, want = out[str(card)], out["cpu"]
    cs.held(got[0], want[0], 1e-4, "explainers, card vs CPU")
    assert np.array_equal(got[1], want[1]) and got[2] == want[2]


# ---------------------------------------------------------------------------
# GraphBolt on the card
# ---------------------------------------------------------------------------


def _gb_table(n=3000, f=16, seed=5):
    return np.random.default_rng(seed).normal(size=(n, f)).astype(np.float32)


def test_graphbolt_feature_caches_on_card(card, tmp_path):
    """``HBMFeatureCache`` and ``DeviceCachedFeature`` keep their tables on
    the card and read the host rows exactly (hits, misses and padding id 0
    repeated), over the pread disk feature and in memory."""
    from dgl_tpu_torch import graphbolt as gb

    arr = _gb_table()
    path = str(tmp_path / "feat.npy")
    np.save(path, arr)
    disk = gb.DiskBasedFeature(path)
    ids = np.concatenate([np.zeros(7, np.int64), np.random.default_rng(
        6).integers(0, arr.shape[0], 4000)])
    deg = np.random.default_rng(7).zipf(2.0, arr.shape[0])
    for fb in (disk, gb.NumpyFeature(arr)):
        cache = gb.HBMFeatureCache.from_degrees(fb, deg, 300)
        assert cache._table.device.type == "cuda"
        out = cache.read_batch(ids)
        torch.cuda.synchronize()
        assert out.device.type == "cuda"
        assert torch.equal(out.cpu(), torch.from_numpy(arr[ids]))
        cpu = gb.HBMFeatureCache.from_degrees(fb, deg, 300, device="cpu")
        assert torch.equal(cpu.read_batch(ids), out.cpu())
        assert (cache.hits, cache.misses) == (cpu.hits, cpu.misses)
        assert 0 < cache.hits < ids.shape[0]
        dcf = gb.gpu_cached_feature(fb, 16 * 4 * 500)
        assert dcf._cache.table.device.type == "cuda"
        got = dcf.read(ids)
        torch.cuda.synchronize()
        assert got.device.type == "cuda"
        assert torch.equal(got.cpu(), torch.from_numpy(arr[ids]))
        assert dcf.hits + dcf.misses == ids.shape[0] and dcf.hits > 0
    disk.close()


def test_graphbolt_copy_to_overlap_copy_on_card(card):
    """``CopyTo`` under ``DataLoader(overlap_copy=True)`` and under the
    prefetch thread gives the inline run's batches: seeds, labels, input
    ids, features (through the card cache) and blocks, all on the card."""
    import chip_smoke as cs
    from dgl_tpu_torch import graphbolt as gb

    g = _sampler_graph(card)
    arr = _gb_table(g.num_nodes(), 8)
    labels = np.arange(g.num_nodes()) % 4

    def batches(**kw):
        cache = gb.HBMFeatureCache(gb.NumpyFeature(arr),
                                   np.arange(0, g.num_nodes(), 2))
        dp = gb.ItemSampler(gb.ItemSet((np.arange(0, 3000, 2),
                                        labels[:3000:2]),
                                       names=("seeds", "labels")),
                            batch_size=256, shuffle=True, seed=3)
        dp = gb.NeighborSamplerStage(dp, g, [4, 4], 256, seed=2)
        dp = gb.FeatureFetcher(dp, gb.FeatureStore(
            {("node", "_N", "feat"): cache}), ["feat"])
        dp = gb.CopyTo(dp, "cuda")
        return [(mb.seeds, mb.labels, torch.from_numpy(mb.input_nodes),
                 mb.node_features["feat"], mb.blocks)
                for mb in gb.DataLoader(dp, **kw)]

    inline = batches(use_prefetch_thread=False)
    assert len(inline) == 6
    for kw in (dict(overlap_copy=True), dict(overlap_copy=False)):
        got = batches(**kw)
        torch.cuda.synchronize()
        assert len(got) == len(inline)
        for a, b in zip(got, inline):
            for x, y in zip(a[:4], b[:4]):
                assert x.device == y.device and torch.equal(x, y)
            assert a[0].device.type == "cuda" and a[3].device.type == "cuda"
            for ba, bb in zip(a[4], b[4]):
                assert ba.device.type == "cuda"
                cs.same_graph_on(ba, bb, "a block")
        for s, _, i, f, _ in got:
            assert torch.equal(f.cpu(), torch.from_numpy(arr[i.numpy()]))


def test_graphbolt_device_pipeline_on_card(card):
    """``DeviceNeighborSamplerStage`` and ``DeviceFeatureFetcher`` on the
    card: every pick an in-edge (``chip_smoke.check_device_picks``), the
    features the table's rows, a DeviceSAGE step."""
    import chip_smoke as cs
    from dgl_tpu_torch import graphbolt as gb
    from dgl_tpu_torch.models import DeviceSAGE

    g = _sampler_graph(card)
    arr = _gb_table(g.num_nodes(), 8)
    dp = gb.ItemSampler(gb.ItemSet(np.arange(g.num_nodes())), 512,
                        shuffle=True, seed=0)
    dp = gb.DeviceNeighborSamplerStage(dp, g, [5, 5], seed=1)
    dp = gb.DeviceFeatureFetcher(dp, {"feat": arr})
    model = DeviceSAGE(8, 16, 4, num_layers=2,
                       generator=torch.Generator().manual_seed(0))
    rel = g._relation()
    indptr = rel.csc_indptr.to(torch.int32)
    indices = rel.csc_indices.to(torch.int32)
    for mb in gb.DataLoader(dp):
        mfg = mb.device_mfg
        assert mfg.input_nodes().device.type == "cuda"
        cs.check_device_picks(mfg, indptr, indices, [5, 5])
        x = mb.node_features["feat"]
        assert torch.equal(x.cpu(), torch.from_numpy(
            arr[mfg.input_nodes().cpu().numpy()]))
        model(mfg, x).sum().backward()
    torch.cuda.synchronize()


def test_checkpoint_round_trip_on_card(card, tmp_path):
    """A GCN's state_dict and its Adam state, CUDA tensors both: saved,
    loaded into a fresh model and optimiser on the card, and the logits
    equal exactly."""
    g = dt.add_self_loop(dt.rand_graph(300, 1500, seed=0, device=card))
    x = torch.randn(300, 16, device=card)
    y = torch.randint(0, 4, (300,), device=card)

    def make():
        m = GCN(16, 32, 4, dropout=0.0, device=card)
        return m, torch.optim.Adam(m.parameters(), lr=1e-2)

    def step(m, opt):
        loss = torch.nn.functional.cross_entropy(m(g, x), y)
        opt.zero_grad()
        loss.backward()
        opt.step()

    model, opt = make()
    for _ in range(3):
        step(model, opt)
    path = str(tmp_path / "ck.npz")
    dt.save_checkpoint(path, {"model": model.state_dict(),
                              "opt": opt.state_dict()}, step=3)
    fresh, fresh_opt = make()
    step(fresh, fresh_opt)
    state, n = dt.load_checkpoint(path, {"model": fresh.state_dict(),
                                         "opt": fresh_opt.state_dict()},
                                  return_step=True)
    assert n == 3
    assert state["model"]["conv0.weight"].device.type == "cuda"
    fresh.load_state_dict(state["model"])
    fresh_opt.load_state_dict(state["opt"])
    for k, v in model.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k
    # index_add's atomics reorder the sums unless told not to
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with torch.no_grad():
            assert torch.equal(fresh(g, x), model(g, x))
    finally:
        torch.use_deterministic_algorithms(was)


def test_hetero_from_shared_memory_on_card(card):
    import os
    from multiprocessing import shared_memory

    rng = np.random.default_rng(0)
    hg = dt.heterograph({
        ("u", "r", "v"): (rng.integers(0, 10, 30), rng.integers(0, 8, 30)),
        ("v", "s", "u"): (rng.integers(0, 8, 20), rng.integers(0, 10, 20))},
        device="cpu")
    hg.nodes["u"].data["x"] = torch.arange(10.0)
    hg.edges_view[("u", "r", "v")].data["w"] = torch.arange(30.0)
    name = f"dgl_torch_card_{os.getpid()}"
    hg.shared_memory(name)
    try:
        back = dt.hetero_from_shared_memory(name, device="cuda")
        assert back.device.type == "cuda"
        assert back.nodes["u"].data["x"].device.type == "cuda"
        for cet in hg.canonical_etypes:
            for a, b in zip(hg.edges(etype=cet), back.edges(etype=cet)):
                assert torch.equal(a, b.cpu())
        assert torch.equal(back.nodes["u"].data["x"].cpu(),
                           torch.arange(10.0))
        assert torch.equal(
            back.edges_view[("u", "r", "v")].data["w"].cpu(),
            torch.arange(30.0))
    finally:
        shm = shared_memory.SharedMemory(name)
        shm.close()
        shm.unlink()
