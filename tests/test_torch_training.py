"""The port's training path against ``dgl_tpu``: gradients of the ops,
layers and models, the optimizer step and dropout in training mode.

Inputs are made from seeds with numpy and go to both sides. On the CPU the
port's wrappers run their kernels' plain versions; the reference runs its
CPU path (``_gat_xla_bwd`` for the bitmap GAT, its XLA matmul and shell
sums for the SpMMs).

Tolerances:

- ``bitmap_gat`` gradients: rtol = atol = 1e-4, as for its ``out`` (both
  compute alpha and the products in f32 with ``h`` rounded to bf16, in
  other orders and, on a CPU with AMX, possibly as bf16x3 matmuls), on a
  cotangent of bf16 values: the port's backward hands its kernels ``dz``
  rounded to bf16, as the reference's TPU path does, where the reference's
  CPU path keeps it in f32. On an f32 cotangent: norm-relative 2e-2, the
  reference's bf16 bound for this backward (``der`` subtracts two terms).
- ``bitmap_copy_u_sum`` and the plain g-SpMM: rtol = atol = 1e-5 (the same
  f32 terms, or the same bf16-rounded rows, summed in another order);
  ``hub_copy_u_sum``: rtol = atol = 1e-4, its forward tolerance.
- Model gradients (dropout 0): the port's bf16-flip allowance (as in
  ``test_torch_sage.py``). The two frameworks' f32 matmuls differ in the
  last bit, so an element of an aggregated table that lies on a bf16
  rounding boundary can round to neighbouring bf16 values on the two
  sides, in the forward and in the backward. Per parameter: at most 1
  element in 1000 outside rtol = atol = 1e-4, every element within 2**-8
  of the gradient's largest magnitude.
- Adam on the same gradients: rtol = atol = 1e-6 (the same update formula,
  rounded in another order).
"""
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

import dgl_tpu
from dgl_tpu.models import GAT as JGAT
from dgl_tpu.models import GCN as JGCN
from dgl_tpu.models import GraphSAGE as JGraphSAGE
import dgl_tpu.ops.bitmap_gat as jbg
from dgl_tpu.ops import bitmap_spmm as jb
from dgl_tpu.ops.hub_spmm import build_hub_plan as j_build_hub_plan
from dgl_tpu.ops.hub_spmm import hub_copy_u_sum as j_hub_copy_u_sum
import dgl_tpu_torch as dt
from dgl_tpu_torch import _kernels
from dgl_tpu_torch.models import GAT, GCN, GraphSAGE
from dgl_tpu_torch.nn import GATConv, SAGEConv
from dgl_tpu_torch.ops import bitmap_gat as tbg
from dgl_tpu_torch.ops import bitmap_spmm as tb
from dgl_tpu_torch.ops.hub_spmm import build_hub_plan, hub_copy_u_sum


def _simple_edges(n_src, n_dst, e, seed, symmetric=False, empty_dst=0):
    """Distinct edges; with ``empty_dst`` the last that many destinations
    have no in-edge."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_src, e)
    dst = rng.integers(0, n_dst - empty_dst, e)
    if symmetric:
        src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
    flat = np.unique(dst.astype(np.int64) * n_src + src)
    return (flat % n_src).astype(np.int64), (flat // n_src).astype(np.int64)


def _relations(src, dst, n_src, n_dst):
    jrel = dgl_tpu.heterograph({("u", "e", "v"): (src, dst)},
                               {"u": n_src, "v": n_dst})._relation(None)
    trel = dt.Relation.from_coo(src, dst, n_src, n_dst, device="cpu")
    return jrel, trel


def _vjp(fn, args, cot):
    """The reference's gradients of ``sum(fn(*args) * cot)`` (under
    ``jit``: the reference's eager shell sums take seconds per call)."""
    pull = jax.jit(lambda *a: jax.vjp(fn, *a)[1](jnp.asarray(cot)))
    return [np.asarray(g) for g in pull(*[jnp.asarray(a) for a in args])]


def _bf16_values(x):
    """``x`` (f32) rounded to the nearest bf16 value, ties to even, and
    kept in f32."""
    u = x.astype(np.float32).view(np.uint32)
    u = (u + np.uint32(0x7FFF) + ((u >> np.uint32(16)) & np.uint32(1))) \
        & np.uint32(0xFFFF0000)
    return u.view(np.float32)


def _grads(fn, args, cot):
    """The port's gradients of ``sum(fn(*args) * cot)``."""
    ts = [torch.from_numpy(a).requires_grad_() for a in args]
    (fn(*ts) * torch.from_numpy(cot)).sum().backward()
    return [t.grad.numpy() for t in ts]


# ---------------------------------------------------------------------------
# bitmap_gat backward (kernels B4 and B5)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("symmetric,heads,odim", [
    (False, 3, 5), (False, 1, 41), (True, 4, 16)])
def test_bitmap_gat_grads_match(symmetric, heads, odim):
    """d el, d er, d h against ``jax.grad`` through the reference, which
    runs ``_gat_xla_bwd`` on the CPU. The asymmetric relation (700 sources,
    600 destinations, the last 50 without an in-edge) uses ``bits_rev``;
    the symmetric one uses ``bits`` both ways. The cotangent holds bf16
    values, so the port's rounding of ``dz`` changes nothing."""
    rng = np.random.default_rng(heads * 100 + odim)
    if symmetric:
        n_src = n_dst = 650
        src, dst = _simple_edges(n_src, n_dst, 8000, 1, symmetric=True)
    else:
        n_src, n_dst = 700, 600
        src, dst = _simple_edges(n_src, n_dst, 9000, 2, empty_dst=50)
    jrel, trel = _relations(src, dst, n_src, n_dst)
    jp, tp = jb.build_bitmap_plan(jrel), tb.build_bitmap_plan(trel)
    assert (tp.bits_rev is None) == symmetric
    el = rng.normal(size=(n_src, heads)).astype(np.float32)
    er = rng.normal(size=(n_dst, heads)).astype(np.float32)
    h = rng.normal(size=(n_src, heads, odim)).astype(np.float32)
    cot = _bf16_values(rng.normal(size=(n_dst, heads, odim)))
    ref = _vjp(lambda a, b, c: jbg.bitmap_gat(0.2, jp, a, b, c),
               (el, er, h), cot)
    _kernels.reset_launch_counts()
    got = _grads(lambda a, b, c: tbg.bitmap_gat(0.2, tp, a, b, c),
                 (el, er, h), cot)
    assert not any(_kernels.launch_counts.values())  # plain on the CPU
    for name, g, r in zip(("el", "er", "h"), got, ref):
        assert g.shape == r.shape
        np.testing.assert_allclose(g, r, rtol=1e-4, atol=1e-4, err_msg=name)
    if not symmetric:  # no in-edge: no gradient through those rows' er
        assert not got[1][-50:].any()


def _bitmap_gat_case(seed, heads, odim):
    """An asymmetric relation (700 sources, 600 destinations, the last 50
    without an in-edge), its plans on both sides and f32 operands."""
    n_src, n_dst = 700, 600
    src, dst = _simple_edges(n_src, n_dst, 9000, seed, empty_dst=50)
    jrel, trel = _relations(src, dst, n_src, n_dst)
    rng = np.random.default_rng(seed)
    arrays = [rng.normal(size=s).astype(np.float32)
              for s in ((n_src, heads), (n_dst, heads), (n_src, heads, odim),
                        (n_dst, heads, odim))]
    return (jb.build_bitmap_plan(jrel), tb.build_bitmap_plan(trel),
            *arrays)


@pytest.mark.parametrize("heads,odim", [(3, 5), (2, 16)])
def test_bitmap_gat_grads_f32_cotangent_bf16_bound(heads, odim):
    """On an f32 cotangent the port's backward (``dz`` rounded to bf16 for
    its kernels) against ``jax.grad`` through the reference's CPU path
    (``dz`` in f32): within the reference's bf16 bound, norm-relative
    2e-2 per gradient."""
    jp, tp, el, er, h, cot = _bitmap_gat_case(6, heads, odim)
    assert np.any(_bf16_values(cot) != cot)
    ref = _vjp(lambda a, b, c: jbg.bitmap_gat(0.2, jp, a, b, c),
               (el, er, h), cot)
    got = _grads(lambda a, b, c: tbg.bitmap_gat(0.2, tp, a, b, c),
                 (el, er, h), cot)
    for name, g, r in zip(("el", "er", "h"), got, ref):
        assert g.shape == r.shape
        rel_l2 = np.linalg.norm(g - r) / np.linalg.norm(r)
        assert rel_l2 < 2e-2, (name, rel_l2)


def test_bitmap_gat_backward_hands_kernels_bf16_dz(monkeypatch):
    """``_BitmapGAT.backward`` takes ``c = out . dz`` from the f32
    cotangent and hands B4 and B5 ``dz`` rounded to bf16, as the
    reference's TPU path does (``dgl_tpu/ops/bitmap_gat.py:447-468``)."""
    _, plan, el, er, h, cot = _bitmap_gat_case(7, 2, 6)
    seen = {}
    for name in ("bitmap_gat_bwd_dst", "bitmap_gat_bwd_src"):
        fn = getattr(tbg, name)
        monkeypatch.setattr(tbg, name, lambda *a, _f=fn, _n=name, **k: (
            seen.__setitem__(_n, a), _f(*a, **k))[1])
    ins = [torch.from_numpy(a).requires_grad_() for a in (el, er, h)]
    dz = torch.from_numpy(cot)
    out = tbg.bitmap_gat(0.2, plan, *ins)
    (out * dz).sum().backward()
    assert sorted(seen) == ["bitmap_gat_bwd_dst", "bitmap_gat_bwd_src"]
    c_f32 = (out.detach() * dz).sum(-1)
    c_bf16 = (out.detach() * dz.to(torch.bfloat16).float()).sum(-1)
    assert not torch.equal(c_f32, c_bf16)
    for name, args in seen.items():
        c, dz_k = args[8], args[9]
        assert dz_k.dtype == torch.bfloat16, name
        assert torch.equal(dz_k, dz.to(torch.bfloat16)), name
        assert c.dtype == torch.float32 and torch.equal(c, c_f32), name


def test_bitmap_gat_plain_row_subsets_and_needs_input_grad(monkeypatch):
    """The plain backward on a subset of rows equals the full one's rows
    (dst rows for B4, source rows of the transpose for B5, as the card
    check uses them), and the backward skips the kernel whose inputs need
    no gradient."""
    n_src, n_dst, heads, odim = 700, 600, 2, 6
    src, dst = _simple_edges(n_src, n_dst, 9000, 3, empty_dst=20)
    _, trel = _relations(src, dst, n_src, n_dst)
    plan = tb.build_bitmap_plan(trel)
    rng = np.random.default_rng(4)
    t = lambda *s: torch.from_numpy(  # noqa: E731
        rng.normal(size=s).astype(np.float32))
    el, er, h = t(n_src, heads), t(n_dst, heads), t(n_src, heads, odim)
    elp, erp, hp = tbg._prep(plan, el, er, h)
    out, lse = tbg.bitmap_gat_fwd(plan.bits, trel.csc_indptr,
                                  trel.csc_indices, elp, erp, hp, 0.2, n_dst)
    dz = t(n_dst, heads, odim).to(torch.bfloat16)  # the kernels' dz
    c = (out * dz).sum(-1)
    der = tbg.bitmap_gat_bwd_dst(plan.bits, trel.csc_indptr,
                                 trel.csc_indices, elp, erp, hp, 0.2, lse, c,
                                 dz, n_dst)
    dele, dh = tbg.bitmap_gat_bwd_src(plan.bits_rev, trel.csr_indptr,
                                      trel.csr_indices, elp, erp, hp, 0.2,
                                      lse, c, dz, n_src)
    rows = torch.tensor([0, 5, 299, 580, 599])
    sub = tbg.gat_bwd_dst_plain(plan.bits[rows], elp, erp[rows], hp, 0.2,
                                lse[rows], c[rows], dz[rows], chunk=2)
    torch.testing.assert_close(sub, der[rows], rtol=1e-5, atol=1e-6)
    srows = torch.tensor([0, 7, 350, 699])
    sd, sh = tbg.gat_bwd_src_plain(plan.bits_rev[srows], elp[srows], erp,
                                   hp[srows], 0.2, lse, c, dz, chunk=3)
    torch.testing.assert_close(sd, dele[srows], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(sh, dh[srows], rtol=1e-5, atol=1e-6)

    calls = []
    for name in ("bitmap_gat_bwd_dst", "bitmap_gat_bwd_src"):
        fn = getattr(tbg, name)
        monkeypatch.setattr(tbg, name, lambda *a, _f=fn, _n=name, **k: (
            calls.append(_n), _f(*a, **k))[1])
    er_only = er.clone().requires_grad_()
    tbg.bitmap_gat(0.2, plan, el, er_only, h).sum().backward()
    assert calls == ["bitmap_gat_bwd_dst"]
    calls.clear()
    h_only = h.clone().requires_grad_()
    tbg.bitmap_gat(0.2, plan, el, er, h_only).sum().backward()
    assert calls == ["bitmap_gat_bwd_src"]
    # the loss out.sum() gives dz = 1 and c = out.sum(-1)
    want = tbg.gat_bwd_src_plain(plan.bits_rev[:n_src], elp[:n_src], erp,
                                 hp[:n_src], 0.2, lse, out.sum(-1),
                                 torch.ones_like(dz))[1]
    torch.testing.assert_close(h_only.grad, want)


# ---------------------------------------------------------------------------
# the SpMMs' backwards (kernels B2 and B1 on the transposed structure)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_src,n_dst,symmetric", [
    (4200, 900, False), (1500, 1500, True)])
def test_bitmap_copy_u_sum_grad_matches(n_src, n_dst, symmetric):
    src, dst = _simple_edges(n_src, n_dst, 30000, 5, symmetric=symmetric)
    jrel, trel = _relations(src, dst, n_src, n_dst)
    jp, tp = jb.build_bitmap_plan(jrel), tb.build_bitmap_plan(trel)
    assert (tp.bits_rev is None) == symmetric
    rng = np.random.default_rng(6)
    x = rng.normal(size=(n_src, 24)).astype(np.float32)
    cot = rng.normal(size=(n_dst, 24)).astype(np.float32)
    ref = _vjp(lambda u: jb.bitmap_copy_u_sum(jp, u), (x,), cot)[0]
    _kernels.reset_launch_counts()
    got = _grads(lambda u: tb.bitmap_copy_u_sum(tp, u), (x,), cot)[0]
    assert _kernels.launch_counts["bitmap_spmm"] == 0
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def _skewed_graph(n, e, seed):
    rng = np.random.default_rng(seed)
    w = 1.0 / np.arange(1, n + 1)
    src = rng.choice(n, e, p=w / w.sum())
    dst = rng.choice(n, e, p=(w ** 0.7) / (w ** 0.7).sum())
    return src, dst


@pytest.mark.parametrize("reorder", [False, True])
def test_hub_copy_u_sum_grad_matches(reorder):
    """Unreordered with 64 hubs: cold sources with more than 32 cold
    edges leave a reverse residual, and the reverse rank order is not the
    identity. Reordered: the reference's pinned-hub relabelling."""
    n, e = 4000, 30000
    src, dst = _skewed_graph(n, e, 41)
    jg = dgl_tpu.graph((src, dst), num_nodes=n)
    tg = dt.graph((src, dst), num_nodes=n, device="cpu")
    if reorder:
        jg, _ = dgl_tpu.transforms.reorder_for_spmm(jg, num_hubs=128)
        tg, _ = dt.transforms.reorder_for_spmm(tg, num_hubs=128)
        jplan, tplan = jg._relation().hub_plan, tg._relation().hub_plan
    else:
        jplan = j_build_hub_plan(jg._relation(), 64, "int8")
        tplan = build_hub_plan(tg._relation(), 64, "int8")
        assert tplan.res_src is not None and tplan.unrank_src is not None
    assert tplan.rev_shell_rows
    rng = np.random.default_rng(42)
    x = rng.normal(size=(n, 20)).astype(np.float32)
    cot = rng.normal(size=(n, 20)).astype(np.float32)
    ref = _vjp(lambda u: j_hub_copy_u_sum(jplan, u), (x,), cot)[0]
    got = _grads(lambda u: hub_copy_u_sum(tplan, u), (x,), cot)[0]
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
    # against the exact f32 gradient at the bf16 bound
    exact = _grads(lambda u: dt.ops.copy_u_sum(
        dt.graph(tuple(t.numpy() for t in (tg._relation().src,
                                           tg._relation().dst)),
                 num_nodes=n, device="cpu"), u), (x,), cot)[0]
    np.testing.assert_allclose(got, exact, rtol=2e-2,
                               atol=2e-2 * np.abs(exact).max())


@pytest.mark.parametrize("op,reduce_op", [
    ("copy_lhs", "sum"), ("mul", "sum"), ("mul", "mean"), ("add", "sum"),
    ("div", "sum")])
def test_plain_gspmm_grads_match(op, reduce_op):
    """The plain g-SpMM (autograd through ``index_select``/``index_add``)
    against the reference's hand VJP (``ops/spmm.py:_gspmm_sum_bwd``), on
    a graph with multi-edges and without plans."""
    n, e = 300, 2500
    rng = np.random.default_rng(7)
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    jg = dgl_tpu.graph((src, dst), num_nodes=n)
    tg = dt.graph((src, dst), num_nodes=n, device="cpu")
    u = rng.normal(size=(n, 3, 4)).astype(np.float32)
    w = (rng.random(size=(e, 3, 1)) + 0.5).astype(np.float32)
    cot = rng.normal(size=(n, 3, 4)).astype(np.float32)
    args = (u,) if op == "copy_lhs" else (u, w)

    def jfn(*a):
        return dgl_tpu.ops.gspmm(jg, op, reduce_op, a[0],
                                 a[1] if len(a) > 1 else None)

    def tfn(*a):
        return dt.ops.gspmm(tg, op, reduce_op, a[0],
                            a[1] if len(a) > 1 else None)

    for g, r in zip(_grads(tfn, args, cot), _vjp(jfn, args, cot)):
        np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# model gradients (dropout 0) against flax
# ---------------------------------------------------------------------------


def _assert_grads_close(named_grads, ref_tree):
    ref = dt.from_flax_params(ref_tree)
    assert set(named_grads) == set(ref)
    for name, g in named_grads.items():
        r = ref[name].numpy()
        assert g is not None and g.shape == r.shape, name
        g = g.numpy()
        bad = np.abs(g - r) > 1e-4 + 1e-4 * np.abs(r)
        assert bad.mean() <= 1e-3, f"{name}: {bad.sum()} of {bad.size}"
        np.testing.assert_allclose(g, r, rtol=0,
                                   atol=2.0 ** -8 * np.abs(r).max(),
                                   err_msg=name)


def _labels(n, classes, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, classes, n).astype(np.int32),
            (rng.random(n) < 0.6).astype(np.float32))


def _jloss(logits, y, mask):
    ce = optax.softmax_cross_entropy_with_integer_labels(logits, y)
    return (ce * mask).sum() / mask.sum()


def masked_loss(logits, y, mask):
    """The training step's loss: masked mean cross-entropy."""
    ce = F.cross_entropy(logits, y, reduction="none")
    return (ce * mask).sum() / mask.sum()


def _model_grads(jmodel, tmodel, jg, tg, x, classes, seed):
    y, mask = _labels(x.shape[0], classes, seed)
    params = jmodel.init(jax.random.PRNGKey(seed), jg, jnp.asarray(x))
    jgrads = jax.jit(jax.grad(lambda p: _jloss(
        jmodel.apply(p, jg, jnp.asarray(x)), jnp.asarray(y),
        jnp.asarray(mask))))(params)
    tmodel.load_state_dict(dt.from_flax_params(params))
    tmodel.train()
    loss = masked_loss(tmodel(tg, torch.from_numpy(x)),
                       torch.from_numpy(y).long(), torch.from_numpy(mask))
    loss.backward()
    return {k: p.grad for k, p in tmodel.named_parameters()}, jgrads


def _dense_graphs(n=500, e=15_000, seed=0):
    """Symmetric simple graph with self-loops, density ~0.1: a bitmap plan
    on both sides, no dense-attention mark."""
    src, dst = _simple_edges(n, n, e, seed, symmetric=True)
    loops = np.arange(n)
    flat = np.unique(np.concatenate([dst * n + src, loops * (n + 1)]))
    src, dst = flat % n, flat // n
    kw = dict(num_hubs=16, dense_attn=False)
    jg = dgl_tpu.graph((src, dst), num_nodes=n).with_spmm_plans(**kw)
    tg = dt.graph((src, dst), num_nodes=n, device="cpu").with_spmm_plans(**kw)
    assert tg._relation().bitmap_plan is not None
    return jg, tg


def test_gcn_grads_match():
    jg, tg = _dense_graphs()
    x = np.random.default_rng(1).normal(size=(500, 30)).astype(np.float32)
    got, ref = _model_grads(JGCN(30, 16, 7, dropout=0.0),
                            GCN(30, 16, 7, dropout=0.0, device="cpu"),
                            jg, tg, x, 7, 2)
    _assert_grads_close(got, ref)


@pytest.fixture
def reference_bf16_dz(monkeypatch):
    """The reference's CPU backward of ``bitmap_gat`` (``_gat_xla_bwd``,
    ``dz`` in f32) under its TPU path's ``dz`` contract, which the port
    follows: ``c = out . dz`` from the f32 ``dz`` and the products on
    ``dz`` rounded to bf16 (``dgl_tpu/ops/bitmap_gat.py:447-468``).
    ``_gat_xla_bwd`` takes ``c`` from its own ``out`` and ``dz``, so it
    runs on the bf16 ``dz`` with one more feature: 0 in ``h``, 1 in
    ``out`` and in ``dz`` the rest of the f32 ``c``. The backward is linear
    in ``dz`` and ``c``, and that feature adds to ``c`` only."""
    orig = jbg._gat_xla_bwd

    def bwd(bits, bits_t, el, er, h, slope, lse, out, dz):
        dzb = dz.astype(jnp.bfloat16).astype(jnp.float32)
        rest = jnp.einsum("dho,dho->dh", out, dz - dzb)[..., None]

        def widen(x, col):
            return jnp.concatenate([x, col], axis=2)

        dele, der, dh = orig(
            bits, bits_t, el, er, widen(h, jnp.zeros_like(h[..., :1])),
            slope, lse, widen(out, jnp.ones_like(out[..., :1])),
            widen(dzb, rest))
        return dele, der, dh[..., :-1]

    monkeypatch.setattr(jbg, "_gat_xla_bwd", bwd)


def _rel_l2(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def test_reference_bf16_dz_oracle(reference_bf16_dz):
    """``reference_bf16_dz`` itself, on an f32 cotangent: its gradients
    against a dense float64 evaluation of the contract (alpha and B from
    the forward, ``c`` from the f32 ``dz``, every product on ``dz`` rounded
    to bf16) at rtol = 1e-4, atol = 1e-4 * max|ref|; and against the
    reference's TPU path, ``_gat_bwd`` through its Pallas kernels in
    interpret mode, within the bounds of
    ``tests/test_bitmap_gat.py::test_pallas_interpret_matches_xla``
    (norm-relative 5e-3 for ``del`` and ``dh``, 2.5e-2 for ``der``)."""
    seed, heads, odim, slope = 11, 2, 8, 0.2
    jp, _, el, er, h, cot = _bitmap_gat_case(seed, heads, odim)
    src, dst = _simple_edges(700, 600, 9000, seed, empty_dst=50)
    fn = lambda a, b, c: jbg.bitmap_gat(slope, jp, a, b, c)  # noqa: E731
    oracle = _vjp(fn, (el, er, h), cot)

    adj = np.zeros((600, 700), bool)
    adj[dst, src] = True
    hb = _bf16_values(h).astype(np.float64)
    z = er.astype(np.float64)[:, None, :] + el.astype(np.float64)[None]
    raw = np.where(z > 0, z, slope * z)  # (d, s, head)
    logits = np.where(adj[..., None], raw, -np.inf)
    m = logits.max(1, keepdims=True)
    p = np.where(adj[..., None], np.exp(logits - np.where(np.isfinite(m), m,
                                                          0.0)), 0.0)
    den = p.sum(1, keepdims=True)
    alpha = np.divide(p, den, out=np.zeros_like(p), where=den > 0)
    b = alpha * np.where(z > 0, 1.0, slope)
    out = np.einsum("dsk,sko->dko", alpha, hb)
    c = np.einsum("dko,dko->dk", out, cot.astype(np.float64))
    dzb = _bf16_values(cot).astype(np.float64)
    hdz = np.einsum("sko,dko->dsk", hb, dzb)
    want = (np.einsum("dsk,dsk->sk", b, hdz) - np.einsum("dsk,dk->sk", b, c),
            np.einsum("dsk,dsk->dk", b, hdz) - c * b.sum(1),
            np.einsum("dsk,dko->sko", alpha, dzb))
    for name, g, w in zip(("el", "er", "h"), oracle, want):
        np.testing.assert_allclose(g, w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max(), err_msg=name)

    jbg._FORCE_PALLAS_INTERPRET = True
    try:
        pallas = _vjp(fn, (el, er, h), cot)
    finally:
        jbg._FORCE_PALLAS_INTERPRET = False
    for name, g, r, tol in zip(("el", "er", "h"), oracle, pallas,
                               (5e-3, 2.5e-2, 5e-3)):
        assert _rel_l2(g, r) < tol, (name, _rel_l2(g, r))


def test_gat_grads_match(reference_bf16_dz):
    """Against the reference with its TPU path's ``dz`` contract for the
    bitmap GAT backward (``reference_bf16_dz``)."""
    jg, tg = _dense_graphs()
    x = np.random.default_rng(3).normal(size=(500, 24)).astype(np.float32)
    got, ref = _model_grads(
        JGAT(24, 8, 5, heads=4, feat_drop=0.0, attn_drop=0.0),
        GAT(24, 8, 5, heads=4, feat_drop=0.0, attn_drop=0.0, device="cpu"),
        jg, tg, x, 5, 4)
    _assert_grads_close(got, ref)


def test_graphsage_grads_match():
    """3 layers 16 -> 32 -> 32 -> 8 on a reordered zipf graph (hub path):
    layer 0 aggregates the raw input, layers 1 and 2 run the hub
    backward."""
    n, e = 4000, 24_000
    rng = np.random.default_rng(5)
    w = 1.0 / np.arange(1, n + 1)
    src = rng.choice(n, e, p=w / w.sum())
    dst = rng.integers(0, n, e)
    x = rng.normal(size=(n, 16)).astype(np.float32)
    jg, _ = dgl_tpu.transforms.reorder_for_spmm(
        dgl_tpu.graph((src, dst), num_nodes=n), num_hubs=256,
        precision="int8")
    tg, _ = dt.transforms.reorder_for_spmm(
        dt.graph((src, dst), num_nodes=n, device="cpu"), num_hubs=256,
        precision="int8")
    assert tg._relation().hub_plan is not None
    got, ref = _model_grads(JGraphSAGE(16, 32, 8, num_layers=3, dropout=0.0),
                            GraphSAGE(16, 32, 8, num_layers=3, dropout=0.0,
                                      device="cpu"), jg, tg, x, 8, 6)
    _assert_grads_close(got, ref)


# ---------------------------------------------------------------------------
# optimizer and dropout
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("steps", [1, 3])
def test_adam_matches_optax(steps):
    """``torch.optim.Adam(lr)`` and ``optax.adam(lr)`` (both betas
    (0.9, 0.999), eps 1e-8) on the same gradients, some of them near 0."""
    rng = np.random.default_rng(8)
    shapes = {"w": (20, 7), "b": (7,)}
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()}
    grads = []
    for _ in range(steps):
        g = {k: rng.normal(size=s).astype(np.float32)
             for k, s in shapes.items()}
        g["w"][0] *= 1e-8  # where last-bit differences would flip the sign
        grads.append(g)
    tx = optax.adam(1e-2)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    for g in grads:
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                               state, jp)
        jp = optax.apply_updates(jp, upd)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in params.items()}
    opt = torch.optim.Adam(tp.values(), lr=1e-2)
    for g in grads:
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
    for k in shapes:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("make,attr,p", [
    (lambda: GCN(4, 4, 2, dropout=0.5, device="cpu"), "dropout", 0.5),
    (lambda: GraphSAGE(4, 4, 2, dropout=0.5, device="cpu"), "dropout", 0.5),
    (lambda: GATConv(4, 4, 2, feat_drop=0.6, device="cpu"), "feat_drop", 0.6),
    (lambda: SAGEConv(4, 4, feat_drop=0.2, device="cpu"), "feat_drop", 0.2),
], ids=["GCN", "GraphSAGE", "GATConv", "SAGEConv"])
def test_dropout_statistics(make, attr, p):
    """Training mode keeps each element with probability 1 - p and scales
    it by 1 / (1 - p), as flax's ``nn.Dropout``; eval mode is the
    identity. 200,000 draws: the keep rate within 5 standard deviations."""
    torch.manual_seed(0)
    drop = getattr(make().train(), attr)
    x = torch.ones(200_000)
    y = drop(x)
    kept = y != 0
    rate = kept.float().mean().item()
    assert abs(rate - (1 - p)) < 5 * np.sqrt(p * (1 - p) / x.numel())
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / (1 - p)))
    drop.eval()
    assert torch.equal(drop(x), x)


def test_gatconv_draws_separate_src_and_dst_masks():
    """With ``feat_drop`` in training the reference drops the source and
    destination features with separate masks (``gatconv.py:46-48``), so
    the projection runs twice on differently dropped inputs; in eval mode
    it runs once."""
    _, tg = _dense_graphs(n=300, e=3000)
    conv = GATConv(6, 4, 2, feat_drop=0.5, device="cpu")
    seen = []
    conv.fc.register_forward_hook(lambda m, a, o: seen.append(a[0]))
    x = torch.ones(300, 6)
    conv.train()(tg, x)
    assert len(seen) == 2 and not torch.equal(seen[0], seen[1])
    seen.clear()
    conv.eval()(tg, x)
    assert len(seen) == 1 and torch.equal(seen[0], x)


def test_training_steps_lower_the_loss():
    """Five Adam steps of each model in training mode (dropout on) on the
    CPU: finite losses, and the last below the first."""
    _, tg = _dense_graphs()
    x = torch.from_numpy(np.random.default_rng(9).normal(
        size=(500, 12)).astype(np.float32))
    y, mask = (torch.from_numpy(a) for a in _labels(500, 5, 10))
    gen = lambda: torch.Generator().manual_seed(0)  # noqa: E731
    for model in (GCN(12, 16, 5, generator=gen(), device="cpu"),
                  GAT(12, 4, 5, heads=2, feat_drop=0.1, attn_drop=0.0,
                      generator=gen(), device="cpu"),
                  GraphSAGE(12, 16, 5, num_layers=2, generator=gen(),
                            device="cpu")):
        torch.manual_seed(1)
        opt = torch.optim.Adam(model.parameters(), lr=1e-2)
        model.train()
        losses = []
        for _ in range(5):
            opt.zero_grad()
            loss = masked_loss(model(tg, x), y.long(), mask)
            loss.backward()
            opt.step()
            losses.append(loss.item())
        assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
