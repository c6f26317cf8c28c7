"""GATConv's per-edge route (``apply_edges(u_add_v)``, leaky ReLU,
``edge_softmax``, ``update_all(u_mul_e, sum)``) against ``dgl_tpu``'s on a
graph without plans, with the same parameters (carried over by
``from_flax_params``): outputs, attention and parameter gradients; a
3-layer GAT; and, in the port, the per-edge route against the bitmap route
(kernel B3's module) on one graph.

Tolerances:

- Port against reference: rtol = atol = 1e-4. Every step is f32 on both
  sides, but the projections are f32 matmuls whose last bits differ
  between the frameworks (and on a CPU with AMX may run as bf16x3, about
  1.5e-5 relative, ``tests/test_torch_gcn_gat.py``); the sums run in other
  orders.
- Per-edge route against bitmap route: B3's tolerance, rtol = 1e-4 and
  atol = 1e-5 * max|ref|. The bitmap route rounds the projected features
  to bf16, so the layer's weights and input are chosen so that they are
  exact in bf16 (multiples of 1/8 with few bits); what remains is f32
  rounding in other orders.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dgl_tpu
from dgl_tpu.models import GAT as JGAT
from dgl_tpu.nn import GATConv as JGATConv
import dgl_tpu_torch as dt
from dgl_tpu_torch import _kernels
from dgl_tpu_torch.models import GAT
from dgl_tpu_torch.nn import GATConv

TOL = dict(rtol=1e-4, atol=1e-4)
N = 300


def _graph(seed=0, n=N, e=2500):
    """A sparse graph with parallel edges and one self-loop per node (no
    zero in-degree), no plan on either side."""
    rng = np.random.default_rng(seed)
    w = 1.0 / np.arange(1, n + 1)
    src = np.concatenate([rng.choice(n, e, p=w / w.sum()), np.arange(n)])
    dst = np.concatenate([rng.integers(0, n, e), np.arange(n)])
    jg = dgl_tpu.graph((src, dst), num_nodes=n)
    tg = dt.graph((src, dst), num_nodes=n, device="cpu")
    assert tg._relation().bitmap_plan is None
    return jg, tg


@pytest.fixture(scope="module")
def graphs():
    return _graph()


def _feat(n, f, seed=1):
    return np.random.default_rng(seed).normal(size=(n, f)).astype(np.float32)


def _port(module, params):
    module.load_state_dict(dt.from_flax_params(params))
    return module.eval()


def _grads_close(port_module, jgrads):
    """The reference's parameter gradients, carried over like the
    parameters, against the port's."""
    want = dt.from_flax_params(jgrads)
    got = {k: p.grad for k, p in port_module.named_parameters()}
    assert set(got) == set(want)
    for k, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[k].numpy(), err_msg=k,
                                   **TOL)


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("with_weight", [False, True])
def test_gatconv_edge_route_matches(graphs, residual, with_weight):
    jg, tg = graphs
    x = _feat(N, 20, 2)
    w = np.random.default_rng(3).random(tg.num_edges()).astype(np.float32)
    jm = JGATConv(20, 6, 3, residual=residual, activation=jax.nn.elu)
    params = jm.init(jax.random.PRNGKey(5), jg, jnp.asarray(x))
    jw = jnp.asarray(w) if with_weight else None

    def jloss(p):
        return (jm.apply(p, jg, jnp.asarray(x), edge_weight=jw) ** 2).sum()

    ref = np.asarray(jm.apply(params, jg, jnp.asarray(x), edge_weight=jw))
    jgrads = jax.grad(jloss)(params)
    tm = _port(GATConv(20, 6, 3, residual=residual,
                       activation=torch.nn.functional.elu, device="cpu"),
               params)
    tw = torch.from_numpy(w) if with_weight else None
    _kernels.reset_launch_counts()
    out = tm(tg, torch.from_numpy(x), edge_weight=tw)
    assert not any(_kernels.launch_counts.values())
    assert out.shape == (N, 3, 6)
    np.testing.assert_allclose(out.detach().numpy(), ref, **TOL)
    (out ** 2).sum().backward()
    _grads_close(tm, jgrads)


def test_gatconv_get_attention(graphs):
    """The attention on every edge (E, H, 1), and the output beside it."""
    jg, tg = graphs
    x = _feat(N, 10, 4)
    jm = JGATConv(10, 4, 2)
    params = jm.init(jax.random.PRNGKey(6), jg, jnp.asarray(x))
    jout, ja = jm.apply(params, jg, jnp.asarray(x), get_attention=True)
    tm = _port(GATConv(10, 4, 2, device="cpu"), params)
    with torch.no_grad():
        out, a = tm(tg, torch.from_numpy(x), get_attention=True)
    assert a.shape == (tg.num_edges(), 2, 1)
    np.testing.assert_allclose(a.numpy(), np.asarray(ja), **TOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    # every destination's attention sums to 1 over its in-edges
    dst = tg._relation().dst.to(torch.int64)
    total = torch.zeros(N, 2).index_add_(0, dst, a[:, :, 0])
    torch.testing.assert_close(total, torch.ones(N, 2))


def test_gat_three_layers_matches(graphs):
    """``GAT(.., num_layers=3)``: parameters ``gat0`` to ``gat2``, forward
    and every parameter's gradient."""
    jg, tg = graphs
    x = _feat(N, 16, 5)
    jm = JGAT(16, 8, 5, heads=3, num_layers=3)
    params = jm.init(jax.random.PRNGKey(7), jg, jnp.asarray(x))
    ref = np.asarray(jm.apply(params, jg, jnp.asarray(x)))
    jgrads = jax.grad(lambda p: (jm.apply(p, jg, jnp.asarray(x))
                                 ** 2).sum())(params)
    tm = _port(GAT(16, 8, 5, heads=3, num_layers=3, device="cpu"), params)
    assert {k.split(".")[0] for k in tm.state_dict()} == {"gat0", "gat1",
                                                         "gat2"}
    out = tm(tg, torch.from_numpy(x))
    assert out.shape == (N, 5)
    np.testing.assert_allclose(out.detach().numpy(), ref, **TOL)
    (out ** 2).sum().backward()
    _grads_close(tm, jgrads)


def test_gat_edge_route_trains(graphs):
    """Training mode with both dropouts: finite gradients for every
    parameter, and the attention dropout only in training mode."""
    _, tg = graphs
    model = GAT(16, 8, 5, heads=3, num_layers=3, feat_drop=0.75,
                attn_drop=0.05, generator=torch.Generator().manual_seed(0),
                device="cpu").train()
    x = torch.from_numpy(_feat(N, 16, 6))
    model(tg, x).square().sum().backward()
    assert all(p.grad is not None and torch.isfinite(p.grad).all()
               for p in model.parameters())
    model.eval()
    torch.testing.assert_close(model(tg, x), model(tg, x))


def _bitmap_graph(n=N, e=6000, seed=8):
    """A simple graph with a self-loop per node and both routes on one
    relation: the bitmap plan attached, the dense-attention mark off."""
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    flat = np.unique(np.concatenate([dst * n + src, np.arange(n) * (n + 1)]))
    g = dt.graph((flat % n, flat // n), num_nodes=n, device="cpu")
    return g.with_spmm_plans(num_hubs=16, dense_attn=False)


def _exact_in_bf16(conv, in_feats, seed):
    """Weights and an input whose projections are exact in bf16."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        conv.fc.weight.copy_(torch.from_numpy(
            rng.integers(-7, 8, tuple(conv.fc.weight.shape)) / 8.0))
    return torch.from_numpy(rng.integers(-1, 2, (N, in_feats)).astype(
        np.float32))


@pytest.mark.parametrize("heads,out_f", [(3, 5), (1, 7)])
def test_edge_route_matches_bitmap_route(heads, out_f):
    """One layer, the same relation: the bitmap route (no edge weight) and
    the per-edge route (an edge weight of ones, which changes nothing) in
    the port, outputs and gradients of the attention vectors. The
    cotangent holds bf16 values: the bitmap route's backward hands its
    kernels ``dz`` in bf16, the per-edge route keeps it in f32."""
    g = _bitmap_graph()
    assert g._relation().bitmap_plan is not None
    conv = GATConv(4, out_f, heads, generator=torch.Generator().manual_seed(1),
                   device="cpu").eval()
    x = _exact_in_bf16(conv, 4, heads)
    ones = torch.ones(g.num_edges())
    cot = torch.from_numpy(np.random.default_rng(out_f).normal(
        size=(N, heads, out_f)).astype(np.float32)).to(torch.bfloat16).float()
    outs, grads = [], []
    for ew in (None, ones):
        conv.zero_grad()
        out = conv(g, x, edge_weight=ew)
        (out * cot).sum().backward()
        outs.append(out.detach())
        grads.append([conv.attn_l.grad.clone(), conv.attn_r.grad.clone()])
    bitmap, edge = outs
    scale = bitmap.abs().max().item()
    torch.testing.assert_close(edge, bitmap, rtol=1e-4, atol=1e-5 * scale)
    for a, b in zip(grads[1], grads[0]):
        torch.testing.assert_close(a, b, rtol=1e-4,
                                   atol=1e-5 * b.abs().max().item())
