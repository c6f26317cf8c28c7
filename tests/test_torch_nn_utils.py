"""The port's ``nn/utils_nn`` (``Identity``, ``Sequential``,
``WeightBasis``, ``JumpingKnowledge``, ``LabelPropagation``),
``nn/functional``, ``nn/link``, ``nn/sparse_emb``, the PNA/DGN helpers,
TWIRLS's functional pieces, AtomicConv's helpers and GroupRevRes's
checkpoint against ``dgl_tpu``'s.

Inputs are made with numpy from a seed; parameters are drawn with numpy at
the reference's ``jax.eval_shape``'d shapes and carried over by
``from_flax_params``. Tolerances: rtol = 1e-4, atol = 1e-4 * max|ref|
(the same f32 operations, in other orders); ``LabelPropagation`` on a
``num_hubs=8`` hub-planned graph at rtol = 2e-2, atol = 2e-2 * max|ref|,
the plan paths' bound (both sides round the gathered rows to bf16; the
reference runs eagerly, one op at a time, so XLA drops no rounding); the
sparse
optimisers at rtol = 1e-5, atol = 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

import dgl_tpu
from dgl_tpu import nn as jnn
from dgl_tpu.nn.conv import atomicconv as jatomic, pna_helpers as jpna
from dgl_tpu.nn.conv import twirlsconv as jtw
import dgl_tpu_torch as dt
from dgl_tpu_torch import nn as tnn
from dgl_tpu_torch.nn.conv import pna_helpers as tpna
from dgl_tpu_torch.ops import hub_spmm

N, E = 80, 500


def _rand(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _close(got, want, tol=1e-4, what=""):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    # D^power of a degree 0 is inf on both sides: the scale is the finite
    # values'
    finite = np.abs(want[np.isfinite(want)])
    np.testing.assert_allclose(np.asarray(got), want, rtol=tol,
                               atol=tol * max(finite.max(initial=0), 1e-30),
                               err_msg=what)


def _params(jmod, *args, scale=0.5):
    shapes = jax.eval_shape(lambda k: jmod.init(k, *args),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(7)
    return jax.tree_util.tree_map(
        lambda s: jnp.asarray((rng.normal(size=s.shape) * scale).astype(
            np.float32)), shapes)


def _edges(seed=0):
    rng = np.random.default_rng(seed)
    return np.minimum(rng.zipf(1.5, E) - 1, N - 1), rng.integers(0, N, E)


@pytest.fixture(scope="module")
def graphs():
    src, dst = _edges()
    jg = dgl_tpu.graph((src, dst), num_nodes=N)
    tg = dt.graph((src, dst), num_nodes=N, device="cpu")
    kw = dict(num_hubs=8, precision="int8")
    jp, _ = dgl_tpu.transforms.reorder_for_spmm(jg, **kw)
    tp, _ = dt.transforms.reorder_for_spmm(tg, **kw)
    return {False: (jg, tg), True: (jp, tp)}


# -- utils_nn ---------------------------------------------------------------


def test_identity_and_jumping_knowledge():
    xs = [_rand((N, 6), i) for i in range(3)]
    x = torch.from_numpy(xs[0])
    assert tnn.Identity()(x) is x
    for mode in ("cat", "max", "sum", "mean"):
        ref = jnn.JumpingKnowledge(mode).apply(
            {}, [jnp.asarray(a) for a in xs])
        _close(tnn.JumpingKnowledge(mode)([torch.from_numpy(a)
                                           for a in xs]), ref, what=mode)
    with pytest.raises(ValueError):
        tnn.JumpingKnowledge("lstm")


def test_weight_basis_matches():
    jmod = jnn.WeightBasis((5, 4), 3, 6)
    params = _params(jmod)
    tmod = tnn.WeightBasis((5, 4), 3, 6, device="cpu")
    tmod.load_state_dict(dt.from_flax_params(params))
    out = tmod()
    assert out.shape == (6, 5, 4)
    _close(out, jmod.apply(params))
    cot = _rand((6, 5, 4), 3)
    gp = jax.grad(lambda p: jnp.sum(jmod.apply(p) * cot))(params)
    (out * torch.from_numpy(cot)).sum().backward()
    for k, v in dt.from_flax_params(gp).items():
        _close(dict(tmod.named_parameters())[k].grad, v.numpy(), what=k)


def test_sequential_of_graph_layers_matches(graphs):
    """Sequential(GraphConv, SAGEConv(gcn)): flax's ``layers_<i>`` land
    on the port's ``layers.<i>``."""
    jg, tg = graphs[False]
    x = _rand((N, 6), 1)
    jmod = jnn.Sequential((jnn.GraphConv(6, 8, allow_zero_in_degree=True),
                           jnn.SAGEConv(8, 5, "gcn")))
    params = _params(jmod, jg, jnp.asarray(x))
    tmod = tnn.Sequential(
        tnn.GraphConv(6, 8, allow_zero_in_degree=True, device="cpu"),
        tnn.SAGEConv(8, 5, "gcn", device="cpu"))
    sd = dt.from_flax_params(params)
    assert set(sd) == set(tmod.state_dict())
    tmod.load_state_dict(sd)
    _close(tmod(tg, torch.from_numpy(x)), jmod.apply(params, jg,
                                                     jnp.asarray(x)))


@pytest.mark.parametrize("planned", [False, True], ids=["plain", "planned"])
@pytest.mark.parametrize("kind", ["ids_masked", "soft_normalized"])
def test_label_propagation_matches(graphs, monkeypatch, planned, kind):
    """k = 4 hops; on the planned graph each hop is one call of B1's
    wrapper (F = the class count)."""
    jg, tg = graphs[planned]
    rng = np.random.default_rng(5)
    calls = [0]
    orig = hub_spmm.shell_prefix_sum

    def count(*a, **k):
        calls[0] += 1
        return orig(*a, **k)

    monkeypatch.setattr(hub_spmm, "shell_prefix_sum", count)
    if kind == "ids_masked":
        labels = rng.integers(0, 5, N).astype(np.int32)
        mask = rng.random(N) < 0.3
        kw = dict(k=4, alpha=0.9)
    else:
        labels = rng.random((N, 5)).astype(np.float32)
        mask = None
        kw = dict(k=4, alpha=0.7, clamp=False, normalize=True)
    # eager: the reference reads the class count on the host (each op
    # runs alone, so its bf16 roundings stay)
    ref = jnn.LabelPropagation(**kw).apply(
        {}, jg, jnp.asarray(labels),
        None if mask is None else jnp.asarray(mask))
    out = tnn.LabelPropagation(**kw)(
        tg, torch.from_numpy(labels),
        None if mask is None else torch.from_numpy(mask))
    assert calls[0] == (4 if planned else 0)
    _close(out, ref, 2e-2 if planned else 1e-4)


def test_functional_edge_softmax(graphs):
    from dgl_tpu.nn import functional as jf

    jg, tg = graphs[False]
    e = _rand((E, 2), 4)
    _close(tnn.functional.edge_softmax(tg, torch.from_numpy(e)),
           jf.edge_softmax(jg, jnp.asarray(e)))


# -- link -------------------------------------------------------------------


@pytest.mark.parametrize("op,out", [("dot", None), ("cos", 3), ("ele", 4),
                                    ("cat", 2)])
def test_edge_predictor_matches(op, out):
    hs, hd = _rand((30, 6), 1), _rand((30, 6), 2)
    jmod = jnn.EdgePredictor(op, 6, out, bias=True)
    params = _params(jmod, jnp.asarray(hs), jnp.asarray(hd))
    tmod = tnn.EdgePredictor(op, 6, out, bias=True, device="cpu")
    tmod.load_state_dict(dt.from_flax_params(params))
    _close(tmod(torch.from_numpy(hs), torch.from_numpy(hd)),
           jmod.apply(params, jnp.asarray(hs), jnp.asarray(hd)))


@pytest.mark.parametrize("p", [1, 2])
@pytest.mark.parametrize("kind", ["transe", "transr"])
def test_transe_transr_match(kind, p):
    """Scores and their gradients, the relation tables included (TransR's
    per-relation (nfeats, rfeats) matrices in ``rel_project``)."""
    rng = np.random.default_rng(3)
    hh, ht = _rand((40, 6), 1), _rand((40, 6), 2)
    rels = rng.integers(0, 4, 40).astype(np.int32)
    if kind == "transe":
        jmod, tmod = jnn.TransE(4, 6, p), tnn.TransE(4, 6, p, device="cpu")
    else:
        jmod = jnn.TransR(4, 5, 6, p)
        tmod = tnn.TransR(4, 5, 6, p, device="cpu")
    args = (jnp.asarray(hh), jnp.asarray(ht), jnp.asarray(rels))
    params = _params(jmod, *args)
    tmod.load_state_dict(dt.from_flax_params(params))
    a = torch.from_numpy(hh).requires_grad_()
    out = tmod(a, torch.from_numpy(ht), torch.from_numpy(rels))
    _close(out, jmod.apply(params, *args))
    gp, gx = jax.grad(lambda pp, x: jnp.sum(jmod.apply(pp, x, *args[1:])),
                      argnums=(0, 1))(params, args[0])
    out.sum().backward()
    _close(a.grad, gx, what="dh")
    for k, v in dt.from_flax_params(gp).items():
        _close(dict(tmod.named_parameters())[k].grad, v.numpy(), what=k)


# -- sparse_emb -------------------------------------------------------------


def test_node_embedding_draw_and_gather():
    ref = jnn.NodeEmbedding(50, 8, seed=3)
    emb = tnn.NodeEmbedding(50, 8, seed=3, device="cpu")
    np.testing.assert_array_equal(emb.weight.numpy(), np.asarray(ref.weight))
    ids = np.array([4, 0, 4, 49])
    np.testing.assert_array_equal(emb(torch.from_numpy(ids)).numpy(),
                                  np.asarray(ref(jnp.asarray(ids))))
    zero = tnn.NodeEmbedding(5, 2, init_func=lambda t: t + 1.0,
                             device="cpu")
    assert (zero.weight == 1.0).all()


@pytest.mark.parametrize("opt", ["adagrad", "adam"])
def test_sparse_optimisers_repeated_ids(opt):
    """Three updates over ids with repeats (a row touched twice in a batch
    takes the sum of its gradients, rows never touched keep their values,
    their moments and counts)."""
    rng = np.random.default_rng(0)
    table = rng.normal(size=(40, 6)).astype(np.float32)
    jt, tt = jnp.asarray(table), torch.from_numpy(table)
    jinit, jupd = ((jnn.sparse_adagrad_init, jnn.sparse_adagrad_update)
                   if opt == "adagrad" else
                   (jnn.sparse_adam_init, jnn.sparse_adam_update))
    tinit, tupd = ((tnn.sparse_adagrad_init, tnn.sparse_adagrad_update)
                   if opt == "adagrad" else
                   (tnn.sparse_adam_init, tnn.sparse_adam_update))
    js, ts = jinit(jt), tinit(tt)
    for step in range(3):
        ids = rng.integers(0, 20, 16)
        ids[:3] = 7  # repeats
        grads = rng.normal(size=(16, 6)).astype(np.float32)
        jt, js = jupd(jt, js, jnp.asarray(ids), jnp.asarray(grads), lr=0.1)
        tt, ts = tupd(tt, ts, torch.from_numpy(ids), torch.from_numpy(grads),
                      lr=0.1)
        np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=1e-5,
                                   atol=1e-6)
        for a, b in zip(ts, js):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                       atol=1e-6)
    np.testing.assert_array_equal(tt[20:].numpy(), table[20:])


# -- pna helpers, TWIRLS pieces, AtomicConv helpers -------------------------


def test_pna_helpers_match():
    h = _rand((12, 5, 4), 1)
    eig_s, eig_d = _rand((12, 5, 3), 2), _rand((12, 5, 3), 3)
    h_in = _rand((12, 4), 4)
    deg = np.random.default_rng(5).integers(1, 6, 12).astype(np.float32)
    for name in jpna.AGGREGATORS:
        _close(tpna.get_aggregate_fn(name)(torch.from_numpy(h)),
               jpna.get_aggregate_fn(name)(jnp.asarray(h)), what=name)
    t = [torch.from_numpy(a) for a in (h, eig_s, eig_d, h_in)]
    j = [jnp.asarray(a) for a in (h, eig_s, eig_d, h_in)]
    _close(tpna.get_aggregate_fn("dir_av-1")(*t[:3]),
           jpna.get_aggregate_fn("dir_av-1")(*j[:3]))
    _close(tpna.get_aggregate_fn("dir_dx-2")(*t),
           jpna.get_aggregate_fn("dir_dx-2")(*j))
    for name in ("scale_identity", "scale_amplification",
                 "scale_attenuation"):
        _close(getattr(tpna, name)(t[3], torch.from_numpy(deg), 1.3),
               getattr(jpna, name)(j[3], jnp.asarray(deg), 1.3), what=name)


def test_twirls_functional_pieces_match(graphs):
    jg, tg = graphs[False]
    x, y = _rand((N, 5), 1), _rand((N, 5), 2)
    jx, jy, tx, ty = (jnp.asarray(x), jnp.asarray(y), torch.from_numpy(x),
                      torch.from_numpy(y))
    _close(tnn.AX(tg, tx), jtw.AX(jg, jx))
    _close(tnn.normalized_AX(tg, tx), jtw.normalized_AX(jg, jx))
    _close(tnn.D_power_bias_X(tg, tx, -0.5, 0.7, 0.3),
           jtw.D_power_bias_X(jg, jx, -0.5, 0.7, 0.3))
    _close(tnn.Propagate()(tg, ty, tx, 0.4, 0.8),
           jtw.Propagate().apply({}, jg, jy, jx, 0.4, 0.8))
    _close(tnn.PropagateNoPrecond()(tg, ty, tx, 0.4, 0.8),
           jtw.PropagateNoPrecond().apply({}, jg, jy, jx, 0.4, 0.8))
    # the attention's weights, then AX over them
    src, dst = _edges()
    keep = src != dst  # no zero distance (the reference's norm is NaN'd)
    jg2 = dgl_tpu.graph((src[keep], dst[keep]), num_nodes=N)
    tg2 = dt.graph((src[keep], dst[keep]), num_nodes=N, device="cpu")
    jw = jtw.Attention(0.3, 2.0, 1.5).reweighting(jg2, jy)
    tw = tnn.Attention(0.3, 2.0, 1.5).reweighting(tg2, ty)
    _close(tw, jw)
    tnn.Attention(0.3, 2.0, 1.5)(tg2, ty)
    assert "w" in tg2.edata
    jg2.edata["w"] = jw
    _close(tnn.AX(tg2, tx), jtw.AX(jg2, jx))


def test_twirls_mlp_matches():
    x = _rand((20, 6), 1)
    jmod = jnn.MLP((8, 8, 3))
    params = _params(jmod, jnp.asarray(x))
    tmod = tnn.MLP(6, (8, 8, 3), device="cpu")
    sd = dt.from_flax_params(params)
    assert set(sd) == set(tmod.state_dict())
    tmod.load_state_dict(sd)
    _close(tmod(torch.from_numpy(x)), jmod.apply(params, jnp.asarray(x)))


def test_atomic_helpers_match(graphs):
    d = np.random.default_rng(2).uniform(0.2, 4.0, (E, 1)).astype(np.float32)
    args = ((2.0, 3.0), (0.5, 1.5), (1.0, 2.0))
    _close(tnn.RadialPooling(*args)(torch.from_numpy(d)),
           jatomic.RadialPooling(*(jnp.asarray(a) for a in args))(
               jnp.asarray(d)))
    jg, tg = graphs[False]
    hv, he = _rand((N, 3), 3), _rand((E, 3), 4)
    jg.ndata["hv"], jg.edata["he"] = jnp.asarray(hv), jnp.asarray(he)
    tg.ndata["hv"], tg.edata["he"] = (torch.from_numpy(hv),
                                      torch.from_numpy(he))
    jg.update_all(jnn.msg_func, jnn.reduce_func)
    tg.update_all(tnn.msg_func, tnn.reduce_func)
    _close(tg.ndata["hv_new"], jg.ndata["hv_new"])


# -- GroupRevRes's checkpoint -----------------------------------------------


def test_grouprevres_checkpoint_replays_dropout(graphs):
    """With ``remat`` each group runs under ``torch.utils.checkpoint``; its
    recomputation in the backward must draw the same dropout masks, so the
    output and every gradient equal the run without it, from the same
    random state. The shared-module form reuses one module in each
    group."""
    _, tg = graphs[False]
    x = torch.from_numpy(_rand((N, 8), 1))

    def run(remat, shared, seed=11):
        gen = torch.Generator().manual_seed(0)
        if shared:
            fac = tnn.SAGEConv(4, 4, feat_drop=0.5, generator=gen,
                               device="cpu")
        else:
            def fac(i):
                return tnn.SAGEConv(4, 4, feat_drop=0.5, generator=gen,
                                    device="cpu")
        mod = tnn.GroupRevRes(fac, 2, remat=remat).train()
        xx = x.clone().requires_grad_()
        torch.manual_seed(seed)
        out = mod(tg, xx)
        (out * out).sum().backward()
        grads = [p.grad.clone() for p in mod.parameters()]
        return out.detach(), xx.grad, grads

    for shared in (False, True):
        a, b = run(False, shared), run(True, shared)
        torch.testing.assert_close(a[0], b[0], rtol=0, atol=0)
        torch.testing.assert_close(a[1], b[1], rtol=1e-6, atol=1e-6)
        for ga, gb in zip(a[2], b[2]):
            torch.testing.assert_close(ga, gb, rtol=1e-6, atol=1e-6)
    # dropout really drew masks: a run from another random state differs
    assert not torch.equal(run(True, False, seed=12)[0], a[0])


def test_invertible_checkpoint_matches_the_plain_call():
    """``InvertibleCheckpoint(fn)`` gives ``fn``'s values and gradients
    (the intermediates recomputed in the backward)."""
    w = torch.from_numpy(_rand((6, 6), 2)).requires_grad_()

    def fn(x):
        return torch.tanh(x @ w) @ w

    x = torch.from_numpy(_rand((5, 6), 1)).requires_grad_()
    out = tnn.InvertibleCheckpoint(fn)(x)
    gx, gw = torch.autograd.grad(out.square().sum(), (x, w))
    ref = fn(x)
    rx, rw = torch.autograd.grad(ref.square().sum(), (x, w))
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    torch.testing.assert_close(gx, rx, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(gw, rw, rtol=1e-6, atol=1e-6)
