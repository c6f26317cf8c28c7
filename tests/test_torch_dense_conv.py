"""The port's dense-adjacency convs (``DenseGraphConv``, ``DenseSAGEConv``,
``DenseChebConv``) against ``dgl_tpu``'s, and against the port's own
graph convs on the same graph (as ``chip_smoke.py`` holds them on the
card): ``DenseGraphConv`` on the adjacency with self-loops equals
``GraphConv``, ``DenseSAGEConv`` on the adjacency without them equals
``SAGEConv(mean)`` on the graph with one self-loop a node (the dense
layer adds the identity), ``DenseChebConv`` equals ``ChebConv`` on a
symmetric graph.

A seeded symmetric random graph of 50 nodes plus a self-loop each (and a
batch of 2 for the reference check); inputs with numpy from a seed,
parameters drawn at the reference's ``jax.eval_shape``'d shapes and
carried over by ``from_flax_params``. Tolerance: rtol = 1e-4,
atol = 1e-4 * max|ref| (the same f32 sums, in other orders), for the
outputs and the gradients of ``sum(out * cot)``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgl_tpu.nn import conv as jc
import dgl_tpu_torch as dt
from dgl_tpu_torch.nn import conv as tc

N, F, O = 50, 12, 6


def _rand(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _graph():
    """(src, dst) of a symmetric graph without self-loops."""
    rng = np.random.default_rng(0)
    a, b = rng.integers(0, N, 160), rng.integers(0, N, 160)
    key = np.unique(np.minimum(a, b)[a != b] * N + np.maximum(a, b)[a != b])
    lo, hi = key // N, key % N
    return np.concatenate([lo, hi]), np.concatenate([hi, lo])


def _adj(src, dst):
    adj = np.zeros((N, N), np.float32)
    adj[dst, src] = 1.0  # rows: destinations
    return adj


def _close(got, want, what=""):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


CASES = {
    "graphconv_both": (lambda: jc.DenseGraphConv(F, O),
                       lambda: tc.DenseGraphConv(F, O, device="cpu")),
    "graphconv_right_narrowing": (
        lambda: jc.DenseGraphConv(F, 3, norm="right"),
        lambda: tc.DenseGraphConv(F, 3, norm="right", device="cpu")),
    "graphconv_none_widening": (
        lambda: jc.DenseGraphConv(F, 20, norm="none"),
        lambda: tc.DenseGraphConv(F, 20, norm="none", device="cpu")),
    "sage": (lambda: jc.DenseSAGEConv(F, O),
             lambda: tc.DenseSAGEConv(F, O, device="cpu")),
    "cheb_k3": (lambda: jc.DenseChebConv(F, O, 3),
                lambda: tc.DenseChebConv(F, O, 3, device="cpu")),
}


@pytest.mark.parametrize("batched", [False, True], ids=["single", "batch2"])
@pytest.mark.parametrize("name", list(CASES))
def test_dense_conv_matches(name, batched):
    src, dst = _graph()
    adj = _adj(np.concatenate([src, np.arange(N)]),
               np.concatenate([dst, np.arange(N)]))
    x = _rand((N, F), 1)
    if batched:
        adj = np.stack([adj, adj[::-1, ::-1].copy()])
        x = np.stack([x, _rand((N, F), 2)])
    jfac, tfac = CASES[name]
    jmod, tmod = jfac(), tfac()
    shapes = jax.eval_shape(lambda k: jmod.init(k, jnp.asarray(adj),
                                                jnp.asarray(x)),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(7)
    params = jax.tree_util.tree_map(lambda s: jnp.asarray(
        (rng.normal(size=s.shape) * 0.5).astype(np.float32)), shapes)
    tmod.load_state_dict(dt.from_flax_params(params))
    cot = _rand(jax.eval_shape(lambda p: jmod.apply(
        p, jnp.asarray(adj), jnp.asarray(x)), params).shape, 3)
    (ref, (gp, gx)) = (
        jmod.apply(params, jnp.asarray(adj), jnp.asarray(x)),
        jax.grad(lambda p, xx: jnp.sum(jmod.apply(p, jnp.asarray(adj), xx)
                                       * cot), argnums=(0, 1))(
            params, jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_()
    out = tmod(torch.from_numpy(adj), xt)
    (out * torch.from_numpy(cot)).sum().backward()
    _close(out.detach().numpy(), ref, "out")
    _close(xt.grad.numpy(), gx, "dx")
    named = dict(tmod.named_parameters())
    for k, v in dt.from_flax_params(gp).items():
        _close(named[k].grad.numpy(), v.numpy(), k)


def test_dense_convs_equal_graph_convs():
    """Each dense conv against its graph conv, the weights shared."""
    src, dst = _graph()
    loops = np.arange(N)
    g = dt.graph((np.concatenate([src, loops]), np.concatenate([dst, loops])),
                 num_nodes=N, device="cpu")
    adj_loops = torch.from_numpy(_adj(np.concatenate([src, loops]),
                                      np.concatenate([dst, loops])))
    adj = torch.from_numpy(_adj(src, dst))
    x = torch.from_numpy(_rand((N, F), 1))
    gen = torch.Generator().manual_seed(0)
    gc = tc.GraphConv(F, O, generator=gen, device="cpu")
    dgc = tc.DenseGraphConv(F, O, device="cpu")
    dgc.load_state_dict({"weight": gc.weight, "bias": gc.bias})
    _close(dgc(adj_loops, x).detach().numpy(), gc(g, x).detach().numpy())
    sage = tc.SAGEConv(F, O, generator=gen, device="cpu")
    with torch.no_grad():
        sage.bias.normal_(generator=gen)
    dsage = tc.DenseSAGEConv(F, O, device="cpu")
    dsage.load_state_dict({
        "fc.weight": torch.cat([sage.fc_self.weight, sage.fc_neigh.weight],
                               1), "fc.bias": sage.bias})
    _close(dsage(adj, x).detach().numpy(), sage(g, x).detach().numpy())
    cheb = tc.ChebConv(F, O, k=3, generator=gen, device="cpu")
    dcheb = tc.DenseChebConv(F, O, 3, device="cpu")
    dcheb.load_state_dict({"W": torch.stack([cheb.w0.weight.T,
                                             cheb.w1.weight.T,
                                             cheb.w2.weight.T]),
                           "bias": cheb.bias})
    _close(dcheb(adj_loops, x).detach().numpy(), cheb(g, x).detach().numpy())
