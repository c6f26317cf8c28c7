"""The port's graph-transformer layers (``nn/gt``) against ``dgl_tpu``'s:
``BiasedMHA``, ``GraphormerLayer``, ``EGTLayer``, ``DegreeEncoder``,
``LapPosEncoder``, ``PathEncoder``, ``SpatialEncoder``,
``SpatialEncoder3d`` and ``gaussian``.

Inputs are a seeded batch of 3 graphs padded to 7 nodes (a padding mask
with fully masked rows where it applies), made with numpy; parameters are
drawn with numpy at the reference's ``jax.eval_shape``'d shapes and
carried over by ``from_flax_params``. Outputs and the gradients of
``sum(out * cot)`` for the float inputs and every parameter are compared
at rtol = 1e-4, atol = 1e-4 * max|ref| (the same f32 operations, in
other orders), dropout off. Some gradients are 0 in exact arithmetic: those
of a bias that adds one value to a whole row of scores, which the softmax
does not see (the key projections' biases where nothing multiplies the
scores, EGT's score bias when no edge update reads the scores); both sides
give rounding noise there, held at atol = 1e-4 times the largest
parameter gradient.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgl_tpu.nn import gt as jgt
import dgl_tpu_torch as dt
from dgl_tpu_torch.nn import gt as tgt

B, NN, D, H = 3, 7, 16, 4


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(
        np.float32)


def _pad_mask():
    """(B, N, N) true at pairs touching a padded node; graph sizes 7, 5,
    3."""
    sizes = np.array([7, 5, 3])
    real = np.arange(NN)[None, :] < sizes[:, None]
    return ~(real[:, :, None] & real[:, None, :])


def _check(jmod, tmod, inputs, diff, tol=1e-4, call_kw=None, zero=()):
    """``inputs``: numpy arrays, the positional inputs; ``diff``: the
    indices of those that get gradients; ``zero``: the parameters whose
    gradient is 0 in exact arithmetic."""
    call_kw = call_kw or {}
    jin = [None if a is None else jnp.asarray(a) for a in inputs]
    shapes = jax.eval_shape(lambda k: jmod.init(k, *jin, **call_kw),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(7)
    params = jax.tree_util.tree_map(
        lambda s: jnp.asarray((rng.normal(size=s.shape) * 0.3).astype(
            np.float32)), shapes)
    sd = dt.from_flax_params(params)
    assert set(sd) == set(tmod.state_dict()), (set(sd),
                                              set(tmod.state_dict()))
    tmod.load_state_dict(sd)
    tmod.eval()

    def outs(o):
        return o if isinstance(o, tuple) else (o,)

    probe = jax.eval_shape(lambda p: outs(jmod.apply(p, *jin, **call_kw)),
                           params)
    cots = [_rand(o.shape, 30 + i) for i, o in enumerate(probe)]

    def loss(p, *xs):
        args = list(jin)
        for i, x in zip(diff, xs):
            args[i] = x
        o = outs(jmod.apply(p, *args, **call_kw))
        return sum(jnp.sum(a * c) for a, c in zip(o, cots)), o

    (_, ref), grads = jax.jit(jax.value_and_grad(
        loss, argnums=tuple(range(len(diff) + 1)), has_aux=True))(
        params, *[jin[i] for i in diff])
    tin = [None if a is None else torch.from_numpy(a) for a in inputs]
    for i in diff:
        tin[i] = tin[i].clone().requires_grad_()
    got = outs(tmod(*tin, **call_kw))
    sum((a * torch.from_numpy(c)).sum() for a, c in zip(got, cots)
        ).backward()

    def close(a, want, what, scale=None):
        want = np.asarray(want)
        scale = np.abs(want).max() if scale is None else scale
        np.testing.assert_allclose(a, want, rtol=tol,
                                   atol=tol * max(scale, 1e-30),
                                   err_msg=what)

    for i, (a, r) in enumerate(zip(got, ref)):
        close(a.detach().numpy(), r, f"out {i}")
    for i, gx in zip(diff, grads[1:]):
        close(tin[i].grad.numpy(), gx, f"d input {i}")
    named = dict(tmod.named_parameters())
    want = dt.from_flax_params(grads[0])
    largest = max(v.abs().max().item() for v in want.values())
    for k, v in want.items():
        close(named[k].grad.numpy(), v.numpy(), f"grad {k}",
              largest if k in zero else None)


@pytest.mark.parametrize("bias_type", ["add", "mul"])
def test_biased_mha_matches(bias_type):
    """Padding rows fully masked: the -1e9 fill keeps them finite."""
    x, ab = _rand((B, NN, D), 1), _rand((B, NN, NN, H), 2)
    _check(jgt.BiasedMHA(D, H, attn_bias_type=bias_type),
           tgt.BiasedMHA(D, H, attn_bias_type=bias_type, device="cpu"),
           [x, ab, _pad_mask()], diff=(0, 1),
           zero=("k_proj.bias",) if bias_type == "add" else ())


@pytest.mark.parametrize("norm_first", [False, True])
def test_graphormer_layer_matches(norm_first):
    x, ab = _rand((B, NN, D), 1), _rand((B, NN, NN, H), 2)
    _check(jgt.GraphormerLayer(D, 24, H, norm_first=norm_first),
           tgt.GraphormerLayer(D, 24, H, norm_first=norm_first,
                               device="cpu"),
           [x, ab, _pad_mask()], diff=(0, 1), zero=("attn.k_proj.bias",))


@pytest.mark.parametrize("edge_update", [True, False])
def test_egt_layer_matches(edge_update):
    x, e = _rand((B, NN, D), 1), _rand((B, NN, NN, 6), 2)
    mask = np.where(_pad_mask(), -1e9, 0.0).astype(np.float32)
    _check(jgt.EGTLayer(D, 6, H, edge_update=edge_update),
           tgt.EGTLayer(D, 6, H, edge_update=edge_update, device="cpu"),
           [x, e, mask], diff=(0, 1),
           zero=() if edge_update else ("e_bias.bias",))


@pytest.mark.parametrize("direction,dims", [("both", 2), ("both", 3),
                                            ("in", 3), ("out", 3)])
def test_degree_encoder_matches(direction, dims):
    rng = np.random.default_rng(4)
    deg = rng.integers(0, 9, (B, NN) if dims == 2 else (B, NN, 2))
    _check(jgt.DegreeEncoder(5, D, direction),
           tgt.DegreeEncoder(5, D, direction, device="cpu"),
           [deg.astype(np.int32)], diff=())


@pytest.mark.parametrize("model_type,n_head", [("Transformer", 2),
                                               ("DeepSet", 1)])
def test_lap_pos_encoder_matches(model_type, n_head):
    """Frequencies past a node's count are NaN: masked, left out of the
    sum."""
    vals, vecs = _rand((20, 5), 1), _rand((20, 5), 2)
    vals[3:6, 3:] = np.nan
    vecs[3:6, 3:] = np.nan
    _check(jgt.LapPosEncoder(model_type, 2, 5, 8, n_head=n_head,
                             num_post_layer=2),
           tgt.LapPosEncoder(model_type, 2, 5, 8, n_head=n_head,
                             num_post_layer=2, device="cpu"),
           [vals, vecs], diff=(),
           zero=("attn0.key.bias", "attn1.key.bias"))


def test_path_encoder_matches():
    rng = np.random.default_rng(3)
    dist = rng.integers(-1, 6, (B, NN, NN)).astype(np.int32)
    path = _rand((B, NN, NN, 5, 6), 4)
    _check(jgt.PathEncoder(4, 6, H), tgt.PathEncoder(4, 6, H, device="cpu"),
           [dist, path], diff=(1,))


def test_spatial_encoder_matches():
    rng = np.random.default_rng(3)
    dist = rng.integers(-1, 9, (B, NN, NN)).astype(np.int32)
    _check(jgt.SpatialEncoder(5, H), tgt.SpatialEncoder(5, H, device="cpu"),
           [dist], diff=())


@pytest.mark.parametrize("typed", [False, True])
def test_spatial_encoder_3d_matches(typed):
    rng = np.random.default_rng(3)
    coord = _rand((B, NN, 3), 5)
    types = rng.integers(0, 10, (B, NN)).astype(np.int32) if typed else None
    _check(jgt.SpatialEncoder3d(6, H, max_node_type=10),
           tgt.SpatialEncoder3d(6, H, max_node_type=10, device="cpu"),
           [coord, types], diff=(0,))


def test_gaussian_matches():
    x, m, s = _rand((10, 4), 1), _rand((4,), 2), np.abs(_rand((4,), 3))
    np.testing.assert_allclose(
        tgt.gaussian(*map(torch.from_numpy, (x, m, s))).numpy(),
        np.asarray(jgt.spatial_encoder.gaussian(
            *map(jnp.asarray, (x, m, s)))), rtol=1e-5, atol=1e-7)
