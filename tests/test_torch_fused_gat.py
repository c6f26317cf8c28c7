"""The port's remaining GAT routes against ``dgl_tpu``: fused shell-space
attention (``ops/fused_gat.py``) over the weighted shell plan, dense masked
attention (``ops/dense_attn.py``) for small graphs, and GATConv's route
order (dense, bitmap, fused, per-edge).

Inputs are made once with numpy and go to both sides; the reference runs
under ``jax.jit`` compiled with ``xla_allow_excess_precision`` off, so its
bf16 operations round as written (the helpers and their reasons are
``test_torch_shell_spmm.py``'s).
Neither route has a Pallas kernel in the reference: the port computes both
with PyTorch operations.

Tolerances:

- f32 plans and f32 dense attention: rtol = 1e-5, atol = 1e-5 * max|ref|
  (the same f32 operations, sums in other orders, ``exp`` from two
  libraries);
- bf16 plans: the same, except that at most 1 element in 1000 may differ
  by one bf16 step (2**-8 * max|ref|): an ``exp`` or a sum that differs in
  the last f32 bit can round to the neighbouring bf16 value;
- bf16 dense attention: the forward as bf16 plans; the gradients at 3e-2
  L2-relative per tensor, the reference's bound for this route's gradients
  (``tests/test_dense_attn.py::test_dense_path_bf16_error_bound``): they
  come from each framework's autodiff of bf16 operations, which round at
  other points (the division's and the exponential's rules);
- GATConv through each route against the reference module with the same
  weights: as the route's op (the bitmap route: B3's bound, rtol = atol =
  1e-4); the 2-layer GAT model: the same rules at 1e-4 in place of 1e-5,
  as ``test_torch_sage.py`` bounds full models (an element of layer 0's
  gradient sums many terms of layer 1's, each of which may hold a bf16
  rounding that differs by one step).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import dgl_tpu
import dgl_tpu.ops.dense_attn as jda
import dgl_tpu.ops.fused_gat as jfg
import dgl_tpu.ops.shell_spmm as jss
from dgl_tpu.models import GAT as JGAT
from dgl_tpu.nn import GATConv as JGATConv
import dgl_tpu_torch as dt
from dgl_tpu_torch.models import GAT
from dgl_tpu_torch.nn import GATConv
from dgl_tpu_torch.ops import dense_attn as tda
from dgl_tpu_torch.ops import fused_gat as tfg
from dgl_tpu_torch.ops import shell_spmm as tss
from test_torch_shell_spmm import _close, _exact, _port_vjp, _ref_vjp

N, E, H, O = 300, 4000, 4, 8


def _powerlaw(seed=0):
    """As ``test_torch_shell_spmm``: both directions pass the shell cap of
    32 (residuals), plus one self-loop a node (no zero in-degree)."""
    rng = np.random.default_rng(seed)
    w = 1.0 / np.arange(1, N + 1)
    src = rng.choice(N, E, p=w / w.sum())
    dst = rng.choice(N, E, p=w[::-1] / w.sum())
    loops = np.arange(N)
    return np.concatenate([src, loops]), np.concatenate([dst, loops])


def _simple(n=200, e=1500, seed=1):
    """Distinct edges plus self-loops: the dense route's graphs."""
    rng = np.random.default_rng(seed)
    flat = np.unique(rng.integers(0, n, e) * n + rng.integers(0, n, e))
    src, dst = flat % n, flat // n
    keep = src != dst
    loops = np.arange(n)
    return (np.concatenate([src[keep], loops]),
            np.concatenate([dst[keep], loops]))


_CACHE = {}


def _cached(key, make):
    if key not in _CACHE:
        _CACHE[key] = make()
    return _CACHE[key]


def _graphs(kind):
    def make():
        src, dst = _powerlaw() if kind == "powerlaw" else _simple()
        n = int(max(src.max(), dst.max())) + 1
        return (dgl_tpu.graph((src, dst), num_nodes=n),
                dt.graph((src, dst), num_nodes=n, device="cpu"))
    return _cached(kind, make)


def _plans(gd):
    def make():
        jg, tg = _graphs("powerlaw")
        return (jss.build_shell_plan(jg._relation(None), gd),
                tss.build_shell_plan(tg._relation(), gd))
    return _cached(("plan", gd), make)


def _l2_close(out, ref, bound, what=""):
    rel = np.linalg.norm(out - ref) / max(np.linalg.norm(ref), 1e-30)
    assert rel < bound, f"{what}: L2-relative {rel}"


def _inputs(n_src, n_dst, seed):
    rng = np.random.default_rng(seed)
    el = rng.normal(size=(n_src, H)).astype(np.float32)
    er = rng.normal(size=(n_dst, H)).astype(np.float32)
    h = rng.normal(size=(n_src, H, O)).astype(np.float32)
    cot = rng.normal(size=(n_dst, H, O)).astype(np.float32)
    return [el, er, h], cot


# ---------------------------------------------------------------------------
# fused shell-space attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("drop", [False, True])
@pytest.mark.parametrize("gd", ["bf16", "f32"])
def test_fused_gat_attention(gd, drop):
    """Forward, ``del``, ``der`` and ``dh`` (the hand backward, both
    residuals), without and with an (E, H) eid-keyed dropout mask."""
    jp, tp = _plans(gd)
    args, cot = _inputs(N, N, 3)
    n_e = _graphs("powerlaw")[1].num_edges()
    mask = None
    if drop:
        keep = np.random.default_rng(4).random((n_e, H)) < 0.7
        mask = (keep / 0.7).astype(np.float32)
    ref, jgrads = _ref_vjp(
        lambda el, er, h: jfg.fused_gat_attention(
            0.2, jp, el, er, h, None if mask is None else jnp.asarray(mask)),
        args, cot)
    out, tgrads = _port_vjp(
        lambda el, er, h: tfg.fused_gat_attention(
            0.2, tp, el, er, h,
            None if mask is None else torch.from_numpy(mask)), args, cot)
    _close(out, ref, gd, "out")
    for name, a, b in zip(("del", "der", "dh"), tgrads, jgrads):
        _close(a, b, gd, name)


def test_fused_gat_matches_the_per_edge_ops():
    """With an f32 plan the fused op is g-SDDMM + edge softmax +
    ``u_mul_e_sum`` (the port's per-edge ops, no plan), forward and
    gradients."""
    _, tp = _plans("f32")
    tg = _graphs("powerlaw")[1]
    args, cot = _inputs(N, N, 5)

    def per_edge(el, er, h):
        e = dt.ops.u_add_v(tg, el, er)
        a = dt.ops.edge_softmax(tg, torch.nn.functional.leaky_relu(e, 0.2))
        return dt.ops.u_mul_e_sum(tg, h, a.unsqueeze(-1))

    ref, rgrads = _port_vjp(per_edge, args, cot)
    out, tgrads = _port_vjp(
        lambda el, er, h: tfg.fused_gat_attention(0.2, tp, el, er, h), args,
        cot)
    _close(out, ref, "f32", "out")
    for a, b in zip(tgrads, rgrads):
        _close(a, b, "f32", "grad")


# ---------------------------------------------------------------------------
# dense masked attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_masked_attention(dtype):
    """``build_dense_adj``'s mask equals the reference's; the attention and
    its gradients (PyTorch's autograd against JAX's) in both types."""
    jg, tg = _graphs("simple")
    n = tg.num_nodes()
    jplan = jda.build_dense_adj(jg._relation(None))
    tplan = tda.build_dense_adj(tg._relation())
    np.testing.assert_array_equal(tplan.mask.numpy(), np.asarray(jplan.mask))
    args, cot = _inputs(n, n, 6)
    ref, jgrads = _ref_vjp(
        lambda el, er, h: jda.dense_masked_attention(
            jplan, el, er, h, compute_dtype=getattr(jnp, dtype)), args, cot)
    out, tgrads = _port_vjp(
        lambda el, er, h: tda.dense_masked_attention(
            tplan, el, er, h, compute_dtype=getattr(torch, dtype)), args, cot)
    gd = "f32" if dtype == "float32" else "bf16"
    _close(out, ref, gd, "out")
    for name, a, b in zip(("del", "der", "dh"), tgrads, jgrads):
        if gd == "f32":
            _close(a, b, gd, name)
        else:
            _l2_close(a, b, 3e-2, name)


def test_dense_adj_gate():
    """The builder refuses multi-edges and graphs over the cell gate, as
    the reference's; zero-in-degree rows give zero rows."""
    g = dt.graph((np.array([0, 0, 1]), np.array([1, 1, 2])), num_nodes=4,
                 device="cpu")
    assert tda.build_dense_adj(g._relation()) is None  # multi-edge
    g = dt.graph((np.array([0, 1]), np.array([1, 2])), num_nodes=4,
                 device="cpu")
    assert tda.build_dense_adj(g._relation(), max_cells=15) is None
    plan = tda.build_dense_adj(g._relation())
    out = tda.dense_masked_attention(plan, torch.ones(4, 2), torch.ones(4, 2),
                                     torch.ones(4, 2, 3))
    assert not out[0].any() and not out[3].any()
    torch.testing.assert_close(out[1], torch.ones(2, 3))
    assert g.with_spmm_plans(num_hubs=4)._relation().dense_adj is not None
    assert g.with_spmm_plans(num_hubs=4, dense_attn=False)._relation(
    ).dense_adj is None


# ---------------------------------------------------------------------------
# GATConv's route order and the GAT model
# ---------------------------------------------------------------------------


def _record(monkeypatch, module, name, calls):
    orig = getattr(module, name)

    def rec(*a, **k):
        calls.append((name, a, k))
        return orig(*a, **k)

    monkeypatch.setattr(module, name, rec)


def _conv_pair(in_f, heads, odim, jg, seed=0, **kw):
    jconv = JGATConv(in_f, odim, heads, allow_zero_in_degree=True, **kw)
    x = np.random.default_rng(seed).normal(size=(jg.num_nodes(), in_f))
    params = jconv.init(jax.random.PRNGKey(seed), jg,
                        jnp.asarray(x, jnp.float32))
    conv = GATConv(in_f, odim, heads, allow_zero_in_degree=True,
                   device="cpu", **{k: v for k, v in kw.items()
                                    if k != "dense_compute_dtype"},
                   dense_compute_dtype=kw.get("dense_compute_dtype",
                                              "bfloat16"))
    conv.load_state_dict(dt.from_flax_params(params))
    return jconv, params, conv.eval(), x.astype(np.float32)


def test_gatconv_route_order(monkeypatch):
    """The reference's order: dense (a dense mask, no edge weight, no
    attention returned), bitmap (also no attention dropout in training),
    fused (a shell plan), else per-edge; each route gives the reference
    module's values with the same weights (eval)."""
    calls = []
    for mod, name in ((tda, "dense_masked_attention"),
                      (tfg, "fused_gat_attention")):
        _record(monkeypatch, mod, name, calls)
    import dgl_tpu_torch.ops.bitmap_gat as tbg
    _record(monkeypatch, tbg, "bitmap_gat", calls)
    jg, tg = _graphs("simple")
    kw = dict(num_hubs=16, weighted=True, gather_dtype="f32")
    both = (jg.with_spmm_plans(**kw, bitmap=True),
            tg.with_spmm_plans(**kw, bitmap=True))
    no_dense = (jg.with_spmm_plans(**kw, bitmap=True, dense_attn=False),
                tg.with_spmm_plans(**kw, bitmap=True, dense_attn=False))
    shell_only = (jg.with_spmm_plans(**kw, bitmap=False, dense_attn=False),
                  tg.with_spmm_plans(**kw, bitmap=False, dense_attn=False))
    assert both[1]._relation().dense_adj is not None
    assert both[1]._relation().bitmap_plan is not None
    assert no_dense[1]._relation().dense_adj is None
    jconv, params, conv, x = _conv_pair(6, 2, 4, jg,
                                        dense_compute_dtype="float32")
    xt = torch.from_numpy(x)
    n_e = tg.num_edges()
    w = np.random.default_rng(2).random(n_e).astype(np.float32)
    for (jgp, tgp), extra, route, tol in (
            (both, {}, "dense_masked_attention", "f32"),
            (both, {"edge_weight": w}, None, "f32"),
            (no_dense, {}, "bitmap_gat", "bf16"),
            (shell_only, {}, "fused_gat_attention", "f32")):
        calls.clear()
        jkw = {k: jnp.asarray(v) for k, v in extra.items()}
        ref = np.asarray(_exact(lambda x: jconv.apply(params, jgp, x, **jkw),
                                x))
        with torch.no_grad():
            out = conv(tgp, xt, **{k: torch.from_numpy(v)
                                   for k, v in extra.items()}).numpy()
        assert [c[0] for c in calls] == ([route] if route else []), route
        if route == "bitmap_gat":  # B3's bf16 h: its own bound
            np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)
        else:
            _close(out, ref, tol, str(route))
    # the attention returned: the per-edge route, on every plan
    calls.clear()
    _, attn = conv(both[1], xt, get_attention=True)
    assert calls == [] and attn.shape == (n_e, 2, 1)
    # attention dropout in training: the bitmap route is left for the
    # fused one, whose (E, H) mask holds 0 or 1/keep
    drop = GATConv(6, 4, 2, attn_drop=0.5, allow_zero_in_degree=True,
                   device="cpu").train()
    calls.clear()
    torch.manual_seed(0)
    out = drop(no_dense[1], xt)
    assert [c[0] for c in calls] == ["fused_gat_attention"]
    mask = calls[0][1][5]
    assert mask.shape == (n_e, 2)
    assert set(torch.unique(mask).tolist()) <= {0.0, 2.0}
    assert 0.4 < float((mask > 0).float().mean()) < 0.6
    assert torch.isfinite(out).all()
    # and the dense route's (H, N, N) dropout in training
    calls.clear()
    assert torch.isfinite(drop(both[1], xt)).all()
    assert [c[0] for c in calls] == ["dense_masked_attention"]
    assert calls[0][2]["dropout_fn"] is not None


@pytest.mark.parametrize("gd", ["bf16", "f32"])
def test_gat_model_weighted(gd):
    """``GAT`` 2 layers under ``with_spmm_plans(weighted=True)`` (no dense
    mask, no bitmap plan): every layer through the fused route, the
    reference's weights carried across with ``from_flax_params``; forward
    and the input's gradient. On the graph of distinct edges (15 and 17
    shell levels, no residual: the op's tests cover the residuals)."""
    jg, tg = _graphs("simple")
    n = tg.num_nodes()
    kw = dict(num_hubs=16, weighted=True, gather_dtype=gd, dense_attn=False,
              bitmap=False)
    jgp, tgp = jg.with_spmm_plans(**kw), tg.with_spmm_plans(**kw)
    jm = JGAT(10, 4, 5, heads=3, num_layers=2)
    x = np.random.default_rng(7).normal(size=(n, 10)).astype(np.float32)
    params = jm.init(jax.random.PRNGKey(0), jg, jnp.asarray(x))
    model = GAT(10, 4, 5, heads=3, num_layers=2, device="cpu").eval()
    model.load_state_dict(dt.from_flax_params(params))
    cot = np.random.default_rng(8).normal(size=(n, 5)).astype(np.float32)
    ref, jgrads = _ref_vjp(lambda x: jm.apply(params, jgp, x), [x], cot)
    out, tgrads = _port_vjp(lambda x: model(tgp, x), [x], cot)
    _close(out, ref, gd, "out", tol=1e-4)
    _close(tgrads[0], jgrads[0], gd, "dx", tol=1e-4)
