"""The port's conv layers GATv2Conv, DotGatConv, AGNNConv, EGATConv,
EdgeGATConv, GINConv, GINEConv, EdgeConv, SGConv, APPNPConv, TAGConv,
ChebConv, GCN2Conv, GatedGraphConv, NNConv, GMMConv and CFConv against
their ``dgl_tpu`` counterparts, one parametrised test.

Each case runs once on a plain graph and once on the same graph with
``with_spmm_plans(num_hubs=8, weighted=True, bitmap=False,
dense_attn=False)`` on both sides (int8 hub plan and bf16 shell plan):
the forward values and the gradients of ``sum(out * cot)`` for the input
and every parameter, the reference's from ``jax.grad`` under ``jax.jit``,
the parameters carried over by ``from_flax_params``. On the planned graph
the port's calls of kernel B1's wrapper (``shell_prefix_sum``, the hub
plan's cold tail) and of B1w's (``shell_prefix_gspmm``) are counted in
the forward; on a CPU tensor each runs its plain version.

The graph: 60 nodes, 420 random edges with a zipf-skewed source (so the
hub plan has hubs and a cold tail) plus a self-loop each; inputs made with
numpy from a seed.

Tolerances: the plain graph rtol = 1e-4, atol = 1e-4 * max|ref| (the same
f32 operations, sums in other orders); the planned graph rtol = 2e-2,
atol = 2e-2 * max|ref| per tensor, the plan paths' bound (``PERF.md``
§2): both sides round gathered rows to bf16 (the reference compiled with
``xla_allow_excess_precision`` off, as ``tests/test_torch_shell_spmm.py``
does), in other orders.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

import dgl_tpu
from dgl_tpu.nn import conv as jc
import dgl_tpu_torch as dt
from dgl_tpu_torch.nn import conv as tc
from dgl_tpu_torch.ops import hub_spmm, shell_prefix

N, F, FE, O, H = 60, 12, 5, 8, 2


def _rand(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _edges():
    rng = np.random.default_rng(0)
    src = np.minimum(rng.zipf(1.6, 420) - 1, N - 1)
    dst = rng.integers(0, N, 420)
    loops = np.arange(N)
    return np.concatenate([src, loops]), np.concatenate([dst, loops])


@pytest.fixture(scope="module")
def graphs():
    src, dst = _edges()
    jg = dgl_tpu.graph((src, dst), num_nodes=N)
    tg = dt.graph((src, dst), num_nodes=N, device="cpu")
    kw = dict(num_hubs=8, weighted=True, bitmap=False, dense_attn=False)
    jp, tp = jg.with_spmm_plans(**kw), tg.with_spmm_plans(**kw)
    rel = tp._relation()
    assert rel.hub_plan is not None and rel.shell_plan is not None
    return {False: (jg, tg), True: (jp, tp)}


# name -> (reference module, port module, extra inputs, forward calls of
# B1's and B1w's wrappers on the planned graph)
# extra inputs: "e" (E, FE) edge features, "w" (E,) positive weights,
# "x0" the initial features, "t" (E,) edge types in [0, 3), "p" (E, 2)
# pseudo-coordinates
CASES = {
    "gatv2": (lambda: jc.GATv2Conv(F, O, H),
              lambda: tc.GATv2Conv(F, O, H, device="cpu"), (), (0, 1)),
    "gatv2_residual_shared": (
        lambda: jc.GATv2Conv(F, O, H, residual=True, share_weights=True),
        lambda: tc.GATv2Conv(F, O, H, residual=True, share_weights=True,
                             device="cpu"), (), (0, 1)),
    "dotgat": (lambda: jc.DotGatConv(F, O, H),
               lambda: tc.DotGatConv(F, O, H, device="cpu"), (), (0, 1)),
    "agnn": (lambda: jc.AGNNConv(init_beta=0.7),
             lambda: tc.AGNNConv(init_beta=0.7, device="cpu"), (), (0, 1)),
    "egat": (lambda: jc.EGATConv(F, FE, O, 6, H),
             lambda: tc.EGATConv(F, FE, O, 6, H, device="cpu"), ("e",),
             (0, 1)),
    "edgegat": (lambda: jc.EdgeGATConv(F, FE, O, H),
                lambda: tc.EdgeGATConv(F, FE, O, H, device="cpu"), ("e",),
                (0, 1)),
    "gin_sum": (lambda: jc.GINConv(fnn.Dense(O), "sum", learn_eps=True),
                lambda: tc.GINConv(torch.nn.Linear(F, O), "sum",
                                   learn_eps=True, device="cpu"), (),
                (1, 0)),
    "gin_mean_weighted": (
        lambda: jc.GINConv(None, "mean", init_eps=0.3),
        lambda: tc.GINConv(None, "mean", init_eps=0.3, device="cpu"),
        ("w",), (0, 1)),
    "gin_max": (lambda: jc.GINConv(fnn.Dense(O), "max"),
                lambda: tc.GINConv(torch.nn.Linear(F, O), "max",
                                   device="cpu"), (), (0, 0)),
    "gine": (lambda: jc.GINEConv(fnn.Dense(O), learn_eps=True),
             lambda: tc.GINEConv(torch.nn.Linear(F, O), learn_eps=True,
                                 device="cpu"), ("eF",), (0, 1)),
    "edgeconv": (lambda: jc.EdgeConv(F, O),
                 lambda: tc.EdgeConv(F, O, device="cpu"), (), (0, 0)),
    "edgeconv_bn": (lambda: jc.EdgeConv(F, O, batch_norm=True),
                    lambda: tc.EdgeConv(F, O, batch_norm=True,
                                        device="cpu"), (), (0, 0)),
    "sgconv": (lambda: jc.SGConv(F, O, k=2),
               lambda: tc.SGConv(F, O, k=2, device="cpu"), (), (2, 0)),
    "sgconv_weighted": (lambda: jc.SGConv(F, O, k=2),
                        lambda: tc.SGConv(F, O, k=2, device="cpu"), ("w",),
                        (0, 2)),
    "appnp": (lambda: jc.APPNPConv(k=3, alpha=0.2),
              lambda: tc.APPNPConv(k=3, alpha=0.2), (), (3, 0)),
    "tagconv": (lambda: jc.TAGConv(F, O, k=2),
                lambda: tc.TAGConv(F, O, k=2, device="cpu"), (), (2, 0)),
    "chebconv": (lambda: jc.ChebConv(F, O, k=3),
                 lambda: tc.ChebConv(F, O, k=3, device="cpu"), (), (2, 0)),
    "gcn2": (lambda: jc.GCN2Conv(F, layer=2),
             lambda: tc.GCN2Conv(F, layer=2, device="cpu"), ("x0",),
             (1, 0)),
    "gcn2_weighted_w2": (
        lambda: jc.GCN2Conv(F, layer=3, project_initial_features=False),
        lambda: tc.GCN2Conv(F, layer=3, project_initial_features=False,
                            device="cpu"), ("x0", "w"), (0, 1)),
    "gatedgraph": (lambda: jc.GatedGraphConv(F, 16, 2, n_etypes=3),
                   lambda: tc.GatedGraphConv(F, 16, 2, n_etypes=3,
                                             device="cpu"), ("t",), (0, 2)),
    "nnconv": (lambda: jc.NNConv(F, O, fnn.Dense(F * O), "mean",
                                 residual=True),
               lambda: tc.NNConv(F, O, torch.nn.Linear(FE, F * O), "mean",
                                 residual=True, device="cpu"), ("e",),
               (0, 1)),
    "gmm_sum": (lambda: jc.GMMConv(F, O, 2, 3, "sum", residual=True),
                lambda: tc.GMMConv(F, O, 2, 3, "sum", residual=True,
                                   device="cpu"), ("p",), (0, 1)),
    "gmm_mean": (lambda: jc.GMMConv(F, O, 2, 3, "mean"),
                 lambda: tc.GMMConv(F, O, 2, 3, "mean", device="cpu"),
                 ("p",), (0, 1)),
    "gmm_max": (lambda: jc.GMMConv(F, O, 2, 3, "max"),
                lambda: tc.GMMConv(F, O, 2, 3, "max", device="cpu"),
                ("p",), (0, 0)),
    "cfconv": (lambda: jc.CFConv(F, FE, 10, O),
               lambda: tc.CFConv(F, FE, 10, O, device="cpu"), ("e",),
               (0, 1)),
}


def _extras(kinds, E):
    rng = np.random.default_rng(9)
    out = []
    for k in kinds:
        if k == "e":
            out.append(_rand((E, FE), 11))
        elif k == "eF":
            out.append(_rand((E, F), 12))
        elif k == "w":
            out.append(rng.uniform(0.5, 1.5, E).astype(np.float32))
        elif k == "x0":
            out.append(_rand((N, F), 13))
        elif k == "t":
            out.append(rng.integers(0, 3, E).astype(np.int32))
        elif k == "p":
            out.append(rng.uniform(-1, 1, (E, 2)).astype(np.float32))
    return out


def _call_args(kinds, g, x, extras, to):
    """The layer's positional arguments (edge weights by keyword)."""
    args, kw = [g, x], {}
    for k, v in zip(kinds, extras):
        if k == "w":
            kw["edge_weight"] = to(v)
        else:
            args.append(to(v))
    return args, kw


def _params(jmod, jargs, x):
    """The reference's parameter tree, drawn with numpy from a seed at the
    shapes ``init`` gives (traced, not run: an eager ``init`` takes
    seconds a layer); EdgeConv's batch statistics at flax's start, mean 0
    and variance 1."""
    shapes = jax.eval_shape(
        lambda k, xx: jmod.init(k, *jargs(xx)[0], **jargs(xx)[1]),
        jax.random.PRNGKey(0), jnp.asarray(x))
    rng = np.random.default_rng(7)
    out = {}
    for col, tree in shapes.items():
        out[col] = jax.tree_util.tree_map_with_path(
            lambda path, s: jnp.asarray(
                (rng.normal(size=s.shape) * 0.5 if col == "params"
                 else np.full(s.shape, float(path[-1].key == "var")))
                .astype(np.float32)), tree)
    return out


def _outputs(out):
    return out if isinstance(out, tuple) else (out,)


@pytest.fixture
def counted(monkeypatch):
    """Count the calls of B1's and B1w's wrappers."""
    calls = {"b1": 0, "b1w": 0}
    b1, b1w = shell_prefix.shell_prefix_sum, shell_prefix.shell_prefix_gspmm

    def count_b1(*a, **k):
        calls["b1"] += 1
        return b1(*a, **k)

    def count_b1w(*a, **k):
        calls["b1w"] += 1
        return b1w(*a, **k)

    monkeypatch.setattr(hub_spmm, "shell_prefix_sum", count_b1)
    monkeypatch.setattr(shell_prefix, "shell_prefix_gspmm", count_b1w)
    return calls


@pytest.mark.parametrize("planned", [False, True], ids=["plain", "planned"])
@pytest.mark.parametrize("name", list(CASES))
def test_conv_matches(graphs, counted, name, planned):
    jfac, tfac, kinds, (n_b1, n_b1w) = CASES[name]
    jg, tg = graphs[planned]
    E = tg._relation().num_edges_padded
    x = _rand((N, F), 1)
    extras = _extras(kinds, E)
    jmod, tmod = jfac(), tfac().eval()
    jargs = lambda xx: _call_args(kinds, jg, xx, extras, jnp.asarray)  # noqa
    targs = lambda xx: _call_args(kinds, tg, xx, extras,  # noqa: E731
                                  torch.from_numpy)
    params = _params(jmod, jargs, x)
    sd = dt.from_flax_params(params.get("params", {}))
    state = tmod.state_dict()
    assert set(sd) <= set(state)
    # buffers only: EdgeConv's batch statistics (flax's start, mean 0 and
    # variance 1, as the port's)
    assert all(k.startswith("bn.running") or k == "bn.num_batches_tracked"
               for k in set(state) - set(sd)), set(state) - set(sd)
    tmod.load_state_dict(sd, strict=False)
    probe = jax.eval_shape(
        lambda p, xx: _outputs(jmod.apply(p, *jargs(xx)[0],
                                          **jargs(xx)[1])),
        params, jnp.asarray(x))
    cots = [_rand(o.shape, 20 + i) for i, o in enumerate(probe)]

    def loss(p, xx):
        aa, kk = jargs(xx)
        outs = _outputs(jmod.apply(p, *aa, **kk))
        return sum(jnp.sum(o * c) for o, c in zip(outs, cots)), outs

    step = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))
    (_, ref), (gp, gx) = step.lower(params, jnp.asarray(x)).compile(
        compiler_options={"xla_allow_excess_precision": False})(
        params, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    a, kw = targs(xt)
    counted.update(b1=0, b1w=0)
    outs = _outputs(tmod(*a, **kw))
    if planned:
        assert (counted["b1"], counted["b1w"]) == (n_b1, n_b1w), counted
    sum((o * torch.from_numpy(c)).sum() for o, c in zip(outs, cots)
        ).backward()
    rtol = 2e-2 if planned else 1e-4

    def close(got, want, what):
        want = np.asarray(want)
        np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                                   atol=rtol * max(np.abs(want).max(),
                                                   1e-30), err_msg=what)

    assert len(outs) == len(ref)
    for i, (o, r) in enumerate(zip(outs, ref)):
        close(o.detach().numpy(), r, f"{name} out {i}")
    close(xt.grad.numpy(), gx, f"{name} dx")
    want = dt.from_flax_params(gp.get("params", {}))
    got = {k: p.grad for k, p in tmod.named_parameters()}
    assert set(want) == set(got), (set(want), set(got))
    for k, v in want.items():
        g = (np.zeros(v.shape, np.float32) if got[k] is None
             else got[k].numpy())
        close(g, v.numpy(), f"{name} grad {k}")
