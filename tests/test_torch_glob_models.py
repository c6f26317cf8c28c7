"""The port's graph-factory layers, global pooling and set-transformer
layers, GIN and Graphormer (``dgl_tpu_torch.nn.factory``, ``nn.glob``,
``models.GIN``, ``models.Graphormer``) against ``dgl_tpu``'s.

The graphs are small random graphs made with numpy from seeds, batched on
both sides. The reference's parameters are drawn with numpy at
``jax.eval_shape``'d shapes and carried over by ``from_flax_params``
(an eager flax ``init`` takes seconds a layer). Each module's output and
the gradients of ``sum(out * cot)`` with respect to every parameter and
the input features must agree within rtol = atol = 1e-4 of max|ref| (the
same f32 operations, sums in other orders; the reference under
``jax.jit``). Graph outputs (the factory layers, ``prepare_batch``) are
held exactly, the kNN graphs under ``test_torch_transforms_pe``'s rule
for float32 near-ties.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

import dgl_tpu
from dgl_tpu.models import GIN as JGIN
from dgl_tpu.models import Graphormer as JGraphormer
from dgl_tpu.models import prepare_batch as j_prepare_batch
from dgl_tpu.nn import factory as jfactory
from dgl_tpu.nn import glob as jglob
import dgl_tpu_torch as dt
from dgl_tpu_torch.models import GIN, Graphormer, prepare_batch
from dgl_tpu_torch.nn import factory as tfactory
from dgl_tpu_torch.nn import glob as tglob
from test_torch_graph_utils import np_of, same_graph
from test_torch_transforms_pe import _knn_edges_equal

TOL = 1e-4
F = 6


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(
        np.float32)


def _graph_list(sizes, seed, lib, **kw):
    rng = np.random.default_rng(seed)
    out = []
    for i, n in enumerate(sizes):
        e = 2 * n
        src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
        out.append(lib.graph((src, dst), num_nodes=n, **kw))
    return out


SIZES = [5, 1, 9, 4, 7]


@pytest.fixture(scope="module")
def batch_pair():
    jb = dgl_tpu.batch(_graph_list(SIZES, 0, dgl_tpu))
    tb = dt.batch(_graph_list(SIZES, 0, dt, device="cpu"))
    return jb, tb


def _check(jinit, japply, tmod, tcall, x, rename=None, jit=True, zero=()):
    """Output and gradients (parameters and ``x``) of the reference
    ``japply(params, x)`` and the port's ``tcall(x)``, the parameters
    drawn at ``jinit(key, x)``'s shapes. ``jit=False`` runs the reference
    eagerly, ``init`` too (its ``topk_nodes`` and ``softmax_nodes`` read
    the segment lengths on the host). A gradient named in ``zero`` is 0 in exact
    arithmetic: it is held within 1e-4 of the largest parameter
    gradient."""
    xj = jnp.asarray(x)
    trace = jax.eval_shape if jit else (lambda f, *a: f(*a))
    shapes = trace(jinit, jax.random.PRNGKey(0), xj)
    rng = np.random.default_rng(7)
    params = jax.tree_util.tree_map(
        lambda s: jnp.asarray((rng.normal(size=s.shape) * 0.4).astype(
            np.float32)), shapes)
    sd = dt.from_flax_params(params, rename)
    assert set(sd) == set(tmod.state_dict()), (set(sd),
                                               set(tmod.state_dict()))
    tmod.load_state_dict(sd)
    tmod.eval()
    cot = _rand(trace(japply, params, xj).shape, 20)

    def loss(p, xx):
        out = japply(p, xx)
        return jnp.sum(out * cot), out

    step = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)
    (_, ref), (gp, gx) = (jax.jit(step) if jit else step)(params, xj)
    xt = torch.from_numpy(x).requires_grad_()
    out = tcall(xt)
    (out * torch.from_numpy(cot)).sum().backward()
    _close(out, ref, "out")
    _close(xt.grad, gx, "dx")
    want = dt.from_flax_params(gp, rename)
    got = dict(tmod.named_parameters())
    assert set(want) == set(got)
    top = max(float(v.abs().max()) for v in want.values()) if want else 0.0
    for k, v in want.items():
        if k in zero:
            np.testing.assert_allclose(np_of(got[k].grad), v.numpy(), rtol=0,
                                       atol=TOL * top, err_msg=k)
        else:
            _close(got[k].grad, v.numpy(), f"grad {k}")
    return out


def _close(got, ref, what):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np_of(got), ref, rtol=TOL,
                               atol=TOL * max(np.abs(ref).max(), 1e-30),
                               err_msg=what)


def _graph_module(jmod, tmod, pair, x, jit=True, zero=()):
    jb, tb = pair
    return _check(lambda k, xx: jmod.init(k, jb, xx),
                  lambda p, xx: jmod.apply(p, jb, xx), tmod,
                  lambda xx: tmod(tb, xx), x, jit=jit, zero=zero)


POOLS = {
    "SumPooling": lambda m, **k: m.SumPooling(),
    "AvgPooling": lambda m, **k: m.AvgPooling(),
    "MaxPooling": lambda m, **k: m.MaxPooling(),
    "SortPooling": lambda m, **k: m.SortPooling(3),
    "SortPooling_k_past_sizes": lambda m, **k: m.SortPooling(8),
    "Set2Set": lambda m, **k: m.Set2Set(F, 3, **k),
    "WeightAndSum": lambda m, **k: m.WeightAndSum(F, **k),
    "SetTransformerEncoder": lambda m, **k: m.SetTransformerEncoder(
        F, 2, 4, 10, n_layers=2, **k),
    "SetTransformerEncoder_isab": lambda m, **k: m.SetTransformerEncoder(
        F, 3, 2, 8, n_layers=1, block_type="isab", m=3, **k),
    "SetTransformerDecoder": lambda m, **k: m.SetTransformerDecoder(
        F, 2, 3, 8, n_layers=2, k=2, **k),
}


@pytest.mark.parametrize("name", sorted(POOLS))
def test_pooling_matches(batch_pair, name):
    x = _rand((sum(SIZES), F), 3)
    has_params = name.startswith(("Set2Set", "WeightAndSum", "SetTrans"))
    kw = dict(device="cpu") if has_params else {}
    _graph_module(POOLS[name](jglob), POOLS[name](tglob, **kw), batch_pair,
                  x, jit=not name.startswith("SortPooling"))


@pytest.mark.parametrize("feat_nn", [False, True])
def test_global_attention_pooling_matches(batch_pair, feat_nn):
    jmod = jglob.GlobalAttentionPooling(fnn.Dense(1),
                                        fnn.Dense(4) if feat_nn else None)
    tmod = tglob.GlobalAttentionPooling(
        torch.nn.Linear(F, 1), torch.nn.Linear(F, 4) if feat_nn else None)
    x = _rand((sum(SIZES), F), 4)
    # the gate's bias shifts every logit of a graph alike: its gradient
    # is 0 in exact arithmetic
    _graph_module(jmod, tmod, batch_pair, x, jit=False,
                  zero={"gate_nn.bias"})
    jb, tb = batch_pair
    out, gate = tmod(tb, torch.from_numpy(x), get_attention=True)
    assert gate.shape == (sum(SIZES), 1)
    sums = torch.zeros(len(SIZES)).index_add(
        0, torch.repeat_interleave(torch.arange(len(SIZES)),
                                   torch.tensor(SIZES)), gate[:, 0])
    np.testing.assert_allclose(sums.detach().numpy(), 1.0, rtol=1e-6)


@pytest.mark.parametrize("block", ["mha", "sab", "isab", "pma"])
def test_set_blocks_match(block):
    x = _rand((3, 5, F), 5)
    mem = _rand((3, 7, F), 6)
    jm = {"mha": lambda m, **k: m.MultiHeadAttention(F, 2, 3, 10, **k),
          "sab": lambda m, **k: m.SetAttentionBlock(F, 2, 3, 10, **k),
          "isab": lambda m, **k: m.InducedSetAttentionBlock(4, F, 2, 3, 10,
                                                           **k),
          "pma": lambda m, **k: m.PMALayer(2, F, 2, 3, 10, **k)}[block]
    jmod, tmod = jm(jglob), jm(tglob, device="cpu")
    if block == "mha":
        _check(lambda k, xx: jmod.init(k, xx, jnp.asarray(mem)),
               lambda p, xx: jmod.apply(p, xx, jnp.asarray(mem)), tmod,
               lambda xx: tmod(xx, torch.from_numpy(mem)), x)
    else:
        _check(jmod.init, jmod.apply, tmod, tmod, x)


def test_dense_batch_round_trip(batch_pair):
    jb, tb = batch_pair
    x = _rand((sum(SIZES), F), 8)
    jx, jmask = jglob._to_dense_batch(jb, jnp.asarray(x))
    tx, tmask = tglob._to_dense_batch(tb, torch.from_numpy(x))
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    back = tglob._from_dense_batch(tb, tx * 2, sum(SIZES) + 3)
    ref = jglob._from_dense_batch(jb, jx * 2, sum(SIZES) + 3)
    np.testing.assert_array_equal(back.numpy(), np.asarray(ref))


# ---------------------------------------------------------------------------
# models
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("readout,learn_eps", [("sum", False),
                                               ("mean", True)])
def test_gin_matches(batch_pair, readout, learn_eps):
    jmod = JGIN(F, 8, 3, num_layers=3, readout=readout, learn_eps=learn_eps)
    tmod = GIN(F, 8, 3, num_layers=3, readout=readout, learn_eps=learn_eps,
               device="cpu")
    jb, tb = batch_pair
    _check(lambda k, xx: jmod.init(k, jb, xx),
           lambda p, xx: jmod.apply(p, jb, xx, deterministic=True), tmod,
           lambda xx: tmod(tb, xx), _rand((sum(SIZES), F), 9))


def _feat_graphs(lib, seed, **kw):
    graphs = _graph_list([6, 3, 8, 1], seed, lib, **kw)
    for i, g in enumerate(graphs):
        x = _rand((g.num_nodes(), F), seed + i)
        g.ndata["feat"] = jnp.asarray(x) if lib is dgl_tpu else \
            torch.from_numpy(x)
    return graphs


def test_prepare_batch_matches():
    got = prepare_batch(_feat_graphs(dt, 1, device="cpu"), max_dist=3)
    ref = j_prepare_batch(_feat_graphs(dgl_tpu, 1), max_dist=3)
    for a, b, dtype in zip(got, ref, (torch.float32, torch.int32,
                                      torch.int64, torch.bool)):
        assert a.dtype == dtype
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_graphormer_matches():
    x, deg, dist, mask = (np.array(a) for a in j_prepare_batch(
        _feat_graphs(dgl_tpu, 2), max_dist=4))
    jmod = JGraphormer(F, 16, 3, num_layers=2, num_heads=4, max_degree=5,
                       max_dist=4)
    tmod = Graphormer(F, 16, 3, num_layers=2, num_heads=4, max_degree=5,
                      max_dist=4, device="cpu")
    args = (jnp.asarray(deg), jnp.asarray(dist), jnp.asarray(mask))
    targs = tuple(torch.from_numpy(a) for a in (deg, dist, mask))
    _check(lambda k, xx: jmod.init(k, xx, *args),
           lambda p, xx: jmod.apply(p, xx, *args, deterministic=True), tmod,
           lambda xx: tmod(xx, *targs), x,
           zero={f"layer{i}.attn.k_proj.bias" for i in range(2)})


# ---------------------------------------------------------------------------
# graph factories
# ---------------------------------------------------------------------------


def test_knn_graph_layers_match():
    x = _rand((4, 12, 3), 10)
    got = tfactory.KNNGraph(3)(torch.from_numpy(x))
    ref = jfactory.KNNGraph(3)(x)
    assert got.batch_size == ref.batch_size == 4
    np.testing.assert_array_equal(np_of(got.edges()[1]),
                                  np.asarray(ref.edges()[1]))
    _knn_edges_equal(got.edges()[0], ref.edges()[0], x.reshape(-1, 3), 3)
    flat = x.reshape(-1, 3)
    one = tfactory.KNNGraph(5)(flat, dist="cosine", device="cpu")
    ref = jfactory.KNNGraph(5)(flat, dist="cosine")
    _knn_edges_equal(one.edges()[0], ref.edges()[0], flat, 5, "cosine")
    segs = [10, 3, 20, 15]
    got = tfactory.SegmentedKNNGraph(4)(torch.from_numpy(flat), segs)
    ref = jfactory.SegmentedKNNGraph(4)(flat, segs)
    np.testing.assert_array_equal(np_of(got.batch_num_nodes()),
                                  np.asarray(ref.batch_num_nodes()))
    np.testing.assert_array_equal(np_of(got.edges()[1]),
                                  np.asarray(ref.edges()[1]))
    offs = np.r_[0, np.cumsum([4 * 10, 3 * 3, 4 * 20, 4 * 15])]
    for (lo, hi), k in zip(zip(offs[:-1], offs[1:]), (4, 3, 4, 4)):
        _knn_edges_equal(np_of(got.edges()[0])[lo:hi],
                         np.asarray(ref.edges()[0])[lo:hi], flat, k)


@pytest.mark.parametrize("p,self_loop", [(2.0, False), (1.0, True)])
def test_radius_graph_layer_matches(p, self_loop):
    x = _rand((30, 3), 11)
    got, gd = tfactory.RadiusGraph(1.2, p, self_loop)(
        torch.from_numpy(x), get_distances=True)
    ref, rd = jfactory.RadiusGraph(1.2, p, self_loop)(x, get_distances=True)
    same_graph(got, ref)
    np.testing.assert_array_equal(gd.numpy(), np.asarray(rd))
