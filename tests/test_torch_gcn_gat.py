"""The port's GCN and GAT inference against ``dgl_tpu``, through the bitmap
path, with the same parameters (carried over by ``from_flax_params``).

Tolerances:

- ``bitmap_gat`` on the same (el, er, h): both compute ``p`` in f32 and
  ``h`` rounded to bf16, with exponentials and sums in other orders. ``lse``
  (no matmul): rtol = atol = 1e-5. ``out`` (the ``p @ h`` product):
  rtol = atol = 1e-4, the bound the card check uses. On a CPU with AMX
  either framework may run an f32 matmul as bf16x3 (about 1.5e-5 relative
  per product when ``h`` is exact in bf16); one full run of the suite
  showed 5.9e-5 where the two sides alone agree to 4e-7.
- A layer whose aggregated table is the same on both sides (GraphConv
  aggregating before its projection, ``precomputed``, the plain path with
  edge weights): rtol = atol = 1e-4, f32 rounding of different orders.
- A layer or model whose aggregated table is itself computed (GraphConv
  projecting first, GATConv, GCN, GAT): the two frameworks' f32 matmuls
  differ in the last bit and an element on a bf16 rounding boundary can
  round to neighbouring bf16 values on the two sides, PR 1's allowance: at
  most 1 element in 1000 outside rtol = atol = 1e-4, every element within
  2**-8 of the output's largest magnitude.

GAT graphs pass ``dense_attn=False`` on both sides, so both take the bitmap
route.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import dgl_tpu
from dgl_tpu.models import GAT as JGAT
from dgl_tpu.models import GCN as JGCN
from dgl_tpu.nn import GATConv as JGATConv
from dgl_tpu.nn import GraphConv as JGraphConv
from dgl_tpu.nn.conv.graphconv import (
    precompute_graphconv as j_precompute_graphconv)
import dgl_tpu.ops.bitmap_gat as jbg
from dgl_tpu.ops.bitmap_spmm import build_bitmap_plan as j_build_bitmap_plan
import dgl_tpu_torch as dt
from dgl_tpu_torch import _kernels
from dgl_tpu_torch.models import GAT, GCN
from dgl_tpu_torch.nn import GATConv, GraphConv, SAGEConv
from dgl_tpu_torch.nn.conv.graphconv import precompute_graphconv
from dgl_tpu_torch.ops import bitmap_gat as tbg
from dgl_tpu_torch.ops.bitmap_spmm import build_bitmap_plan

N = 900


def _assert_close_up_to_bf16_flips(out, ref):
    bad = np.abs(out - ref) > 1e-4 + 1e-4 * np.abs(ref)
    assert bad.mean() <= 1e-3, f"{bad.sum()} of {bad.size} elements"
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=2.0 ** -8 * np.abs(ref).max())


def _dense_graph(n=N, e=40_000, seed=0):
    """A symmetric simple graph with a self-loop on every node (density
    ~0.1): both sides attach a bitmap plan and, for GAT, no dense mask."""
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    loops = np.arange(n)
    src = np.concatenate([src, dst, loops])
    dst = np.concatenate([dst, src[:e], loops])
    flat = np.unique(dst.astype(np.int64) * n + src)
    src, dst = flat % n, flat // n
    kw = dict(num_hubs=16, dense_attn=False)
    jg = dgl_tpu.graph((src, dst), num_nodes=n).with_spmm_plans(**kw)
    tg = dt.graph((src, dst), num_nodes=n, device="cpu").with_spmm_plans(**kw)
    assert jg._relation().bitmap_plan is not None
    assert tg._relation().bitmap_plan is not None
    assert tg._relation().dense_adj is None
    return jg, tg


@pytest.fixture(scope="module")
def graphs():
    return _dense_graph()


def _feat(n, f, seed=1):
    return np.random.default_rng(seed).normal(size=(n, f)).astype(np.float32)


def _port(module, params):
    module.load_state_dict(dt.from_flax_params(params))
    return module.eval()


# ---------------------------------------------------------------------------
# bitmap_gat (kernel B3's module)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("heads,odim", [(4, 16), (1, 41)])
def test_bitmap_gat_matches(heads, odim):
    """out and lse against the reference's ``_gat_xla`` path; the last 50
    destinations have no in-edge."""
    n_src, n_dst, e = 700, 600, 9000
    rng = np.random.default_rng(heads)
    src = rng.integers(0, n_src, e)
    dst = rng.integers(0, n_dst - 50, e)
    pair = np.unique(dst.astype(np.int64) * n_src + src)
    src, dst = pair % n_src, pair // n_src
    jrel = dgl_tpu.heterograph({("u", "e", "v"): (src, dst)},
                               {"u": n_src, "v": n_dst})._relation(None)
    trel = dt.Relation.from_coo(src, dst, n_src, n_dst, device="cpu")
    jplan, tplan = j_build_bitmap_plan(jrel), build_bitmap_plan(trel)
    el = rng.normal(size=(n_src, heads)).astype(np.float32)
    er = rng.normal(size=(n_dst, heads)).astype(np.float32)
    h = rng.normal(size=(n_src, heads, odim)).astype(np.float32)
    jout, jlse = jbg._fwd_impl(0.2, jplan, jnp.asarray(el), jnp.asarray(er),
                               jnp.asarray(h))
    _kernels.reset_launch_counts()
    out = tbg.bitmap_gat(0.2, tplan, torch.from_numpy(el),
                         torch.from_numpy(er), torch.from_numpy(h))
    assert _kernels.launch_counts["bitmap_gat_fwd"] == 0  # plain on the CPU
    assert out.shape == (n_dst, heads, odim) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-4,
                               atol=1e-4)
    elp, erp, hp = tbg._prep(tplan, torch.from_numpy(el),
                             torch.from_numpy(er), torch.from_numpy(h))
    _, lse = tbg.bitmap_gat_fwd(tplan.bits, trel.csc_indptr,
                                trel.csc_indices, elp, erp, hp, 0.2, n_dst)
    live = np.bincount(dst, minlength=n_dst) > 0
    np.testing.assert_allclose(lse.numpy()[live], np.asarray(jlse)[live],
                               rtol=1e-5, atol=1e-5)
    # zero-in-degree rows: out = 0 on both sides, lse = log(1e-30)
    assert (~live).sum() == 50
    assert not out.numpy()[~live].any() and not np.asarray(jout)[~live].any()
    np.testing.assert_allclose(lse.numpy()[~live], np.log(np.float32(1e-30)),
                               rtol=1e-6)
    # the chunked plain version agrees with itself across chunk sizes
    o2, l2 = tbg.gat_fwd_plain(tplan.bits[:n_dst], elp, erp[:n_dst], hp,
                               0.2, chunk=37)
    torch.testing.assert_close(o2, tbg.gat_fwd_plain(
        tplan.bits[:n_dst], elp, erp[:n_dst], hp, 0.2)[0])
    torch.testing.assert_close(l2, lse)


# ---------------------------------------------------------------------------
# GraphConv and GCN (kernel B2 on the path)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("norm", ["both", "right", "left", "none"])
@pytest.mark.parametrize("in_f,out_f", [(24, 8), (8, 24)])
def test_graphconv_matches(graphs, norm, in_f, out_f):
    jg, tg = graphs
    x = _feat(N, in_f)
    jm = JGraphConv(in_f, out_f, norm=norm)
    params = jm.init(jax.random.PRNGKey(0), jg, jnp.asarray(x))
    ref = np.asarray(jm.apply(params, jg, jnp.asarray(x)))
    tm = _port(GraphConv(in_f, out_f, norm=norm, device="cpu"), params)
    assert tm.weight.shape == (in_f, out_f)
    _kernels.reset_launch_counts()
    with torch.inference_mode():
        out = tm(tg, torch.from_numpy(x)).numpy()
    assert out.shape == (N, out_f)
    assert _kernels.launch_counts["bitmap_spmm"] == 0  # plain on the CPU
    if in_f > out_f:  # projects first: the aggregated table is computed
        _assert_close_up_to_bf16_flips(out, ref)
    else:
        np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)


def test_graphconv_precomputed_and_edge_weight(graphs):
    jg, tg = graphs
    x = _feat(N, 8, seed=2)
    jm = JGraphConv(8, 5)
    params = jm.init(jax.random.PRNGKey(1), jg, jnp.asarray(x))
    tm = _port(GraphConv(8, 5, device="cpu"), params)
    jagg = np.asarray(j_precompute_graphconv(jg, jnp.asarray(x), hops=2))
    tagg = precompute_graphconv(tg, torch.from_numpy(x), hops=2)
    _assert_close_up_to_bf16_flips(tagg.numpy(), jagg)
    ref = np.asarray(jm.apply(params, jg, jnp.asarray(jagg),
                              precomputed=True))
    out = tm(tg, torch.from_numpy(np.array(jagg)), precomputed=True)
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=1e-4,
                               atol=1e-4)
    # edge weights take the plain u_mul_e path on both sides (exact f32)
    w = np.random.default_rng(3).random(tg.num_edges()).astype(np.float32)
    ref = np.asarray(jm.apply(params, jg, jnp.asarray(x),
                              edge_weight=jnp.asarray(w)))
    out = tm(tg, torch.from_numpy(x), edge_weight=torch.from_numpy(w))
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=1e-4,
                               atol=1e-4)


def test_gcn_matches(graphs):
    jg, tg = graphs
    x = _feat(N, 30, seed=4)
    jm = JGCN(30, 16, 7)
    params = jm.init(jax.random.PRNGKey(2), jg, jnp.asarray(x))
    ref = np.asarray(jm.apply(params, jg, jnp.asarray(x)))
    tm = _port(GCN(30, 16, 7, device="cpu"), params)
    sd = dt.from_flax_params(params)
    assert set(sd) == set(tm.state_dict())
    np.testing.assert_array_equal(
        sd["conv0.weight"].numpy(),
        np.asarray(params["params"]["conv0"]["weight"]))
    with torch.inference_mode():
        out = tm(tg, torch.from_numpy(x)).numpy()
    assert out.shape == (N, 7)
    _assert_close_up_to_bf16_flips(out, ref)
    # static-input aggregation (layer 0 takes the precomputed aggregate of
    # its input, which the bitmap path rounds to bf16 before projecting)
    jagg = j_precompute_graphconv(jg, jnp.asarray(x))
    ref_s = np.asarray(JGCN(30, 16, 7, static_input_agg=True).apply(
        params, jg, jagg))
    agg = precompute_graphconv(tg, torch.from_numpy(x))
    np.testing.assert_allclose(agg.numpy(), np.asarray(jagg), rtol=1e-4,
                               atol=1e-4)
    tm_s = _port(GCN(30, 16, 7, static_input_agg=True, device="cpu"), params)
    with torch.inference_mode():
        out_s = tm_s(tg, agg).numpy()
    _assert_close_up_to_bf16_flips(out_s, ref_s)


# ---------------------------------------------------------------------------
# GATConv and GAT (kernel B3 on the path)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("residual", [False, True])
def test_gatconv_matches(graphs, residual):
    jg, tg = graphs
    x = _feat(N, 20, seed=5)
    jm = JGATConv(20, 6, 3, residual=residual, activation=jax.nn.elu)
    params = jm.init(jax.random.PRNGKey(3), jg, jnp.asarray(x))
    ref = np.asarray(jm.apply(params, jg, jnp.asarray(x)))
    tm = _port(GATConv(20, 6, 3, residual=residual,
                       activation=torch.nn.functional.elu, device="cpu"),
               params)
    assert tm.attn_l.shape == (1, 3, 6) and tm.bias.shape == (1, 3, 6)
    _kernels.reset_launch_counts()
    with torch.inference_mode():
        out = tm(tg, torch.from_numpy(x)).numpy()
    assert out.shape == (N, 3, 6)
    assert _kernels.launch_counts["bitmap_gat_fwd"] == 0  # plain on the CPU
    _assert_close_up_to_bf16_flips(out, ref)


def test_gat_matches(graphs):
    jg, tg = graphs
    x = _feat(N, 24, seed=6)
    jm = JGAT(24, 8, 5, heads=4)
    params = jm.init(jax.random.PRNGKey(4), jg, jnp.asarray(x))
    ref = np.asarray(jm.apply(params, jg, jnp.asarray(x)))
    tm = _port(GAT(24, 8, 5, heads=4, device="cpu"), params)
    assert set(dt.from_flax_params(params)) == set(tm.state_dict())
    with torch.inference_mode():
        out = tm(tg, torch.from_numpy(x)).numpy()
    assert out.shape == (N, 5)
    _assert_close_up_to_bf16_flips(out, ref)


def test_gatconv_raises_off_the_bitmap_route():
    n = 300
    rng = np.random.default_rng(7)
    src, dst = rng.integers(0, n, 5000), rng.integers(0, n, 5000)
    flat = np.unique(dst * n + src)
    src, dst = flat % n, flat // n
    g = dt.graph((src, dst), num_nodes=n, device="cpu")
    conv = GATConv(6, 4, 2, allow_zero_in_degree=True, device="cpu").eval()
    x = torch.randn(n, 6)
    # the dense route runs since the weighted g-SpMM slice (90,000 cells,
    # the reference's mask): in f32, the per-edge route's values
    gd = g.with_spmm_plans(num_hubs=16)
    assert gd._relation().dense_adj is not None
    assert gd._relation().bitmap_plan is not None
    conv32 = GATConv(6, 4, 2, allow_zero_in_degree=True,
                     dense_compute_dtype="float32", device="cpu").eval()
    conv32.load_state_dict(conv.state_dict())
    torch.testing.assert_close(conv32(gd, x), conv32(g, x), rtol=1e-5,
                               atol=1e-5)
    gb = g.with_spmm_plans(num_hubs=16, dense_attn=False)
    assert conv(gb, x).shape == (n, 2, 4)
    # no plan, an edge weight, the attention returned: the per-edge chain
    # (g-SDDMM, edge_softmax, g-SpMM), ported since the message-passing
    # slice; on the same relation it gives the same values with or
    # without the plans
    edge = conv(g, x)
    assert edge.shape == (n, 2, 4) and torch.isfinite(edge).all()
    rst, attn = conv(gb, x, get_attention=True)
    assert attn.shape == (gb.num_edges(), 2, 1)
    torch.testing.assert_close(rst, edge, rtol=0, atol=0)
    torch.testing.assert_close(
        conv(gb, x, edge_weight=torch.ones(gb.num_edges())), edge,
        rtol=0, atol=0)
    # attention dropout in training mode leaves the bitmap route
    drop = GATConv(6, 4, 2, attn_drop=0.5, allow_zero_in_degree=True,
                   device="cpu").train()
    assert drop(gb, x).shape == (n, 2, 4)
    # a shell plan: the fused shell-space route, since the weighted g-SpMM
    # slice; with an f32 plan, the per-edge route's values
    gs = g.with_spmm_plans(num_hubs=16, weighted=True, gather_dtype="f32",
                           dense_attn=False, bitmap=False)
    assert gs._relation().shell_plan is not None
    torch.testing.assert_close(conv(gs, x), edge, rtol=1e-5, atol=1e-5)


def test_gat_backward_raises(graphs):
    """The backwards that raised before training was ported. GATConv in
    training mode: every parameter gets a gradient, and ``bitmap_gat``'s
    hand backward (B4 and B5's plain versions) equals autograd through its
    plain forward at rtol = atol = 1e-4, on a cotangent of bf16 values (the
    hand backward hands its kernels ``dz`` in bf16). GCN in training mode
    (dropout 0):
    its gradients against the exact f32 path's at the bf16 bound
    rtol = 2e-2, atol = 2e-2 * max|ref|."""
    _, tg = graphs
    conv = GATConv(10, 4, 2, device="cpu").train()  # attn_drop = 0
    conv(tg, torch.randn(N, 10)).sum().backward()
    assert all(p.grad is not None and torch.isfinite(p.grad).all()
               for p in conv.parameters())
    plan = tg._relation().bitmap_plan
    rng = np.random.default_rng(8)
    el, er, h, dz = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
                     for s in ((N, 2), (N, 2), (N, 2, 4), (N, 2, 4)))
    dz = dz.to(torch.bfloat16).float()
    ins = [t.clone().requires_grad_() for t in (el, er, h)]
    (tbg.bitmap_gat(0.2, plan, *ins) * dz).sum().backward()
    refs = [t.clone().requires_grad_() for t in (el, er, h)]
    # h rounded to bf16 in value only: the hand backward keeps dh in f32
    hq = refs[2] + (refs[2].to(torch.bfloat16).float() - refs[2]).detach()
    ws = plan.bits.shape[1] * 8
    out, _ = tbg.gat_fwd_plain(plan.bits[:N], tbg._pad_rows(refs[0], ws),
                               refs[1], tbg._pad_rows(hq, ws), 0.2)
    (out * dz).sum().backward()
    for a, b in zip(ins, refs):
        torch.testing.assert_close(a.grad, b.grad, rtol=1e-4, atol=1e-4)
    rel = tg._relation()
    g_exact = dt.graph((rel.src.numpy(), rel.dst.numpy()), num_nodes=N,
                       device="cpu")
    x = torch.randn(N, 10)
    grads = []
    for g in (tg, g_exact):
        gcn = GCN(10, 4, 3, dropout=0.0,
                  generator=torch.Generator().manual_seed(0),
                  device="cpu").train()
        gcn(g, x).square().sum().backward()
        grads.append([p.grad for p in gcn.parameters()])
    for a, b in zip(*grads):
        scale = b.abs().max().item()
        torch.testing.assert_close(a, b, rtol=2e-2, atol=2e-2 * scale)


@pytest.mark.parametrize("make", [
    lambda: SAGEConv(6, 4, device="cpu"),
    lambda: GraphConv(6, 4, device="cpu"),
    lambda: GATConv(6, 4, 2, residual=True, device="cpu"),
    lambda: GCN(6, 5, 3, device="cpu"),
    lambda: GAT(6, 5, 3, heads=2, device="cpu"),
], ids=["SAGEConv", "GraphConv", "GATConv", "GCN", "GAT"])
def test_layers_build_on_the_cpu(make):
    module = make()
    params = list(module.parameters())
    assert params and all(p.device.type == "cpu" for p in params)
