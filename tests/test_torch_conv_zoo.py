"""The port's conv layers GATv2Conv, DotGatConv, AGNNConv, EGATConv,
EdgeGATConv, GINConv, GINEConv, EdgeConv, SGConv, APPNPConv, TAGConv,
ChebConv, GCN2Conv, GatedGraphConv, NNConv, GMMConv, CFConv, PNAConv,
PNAConvTower, DGNConv, DGNConvTower, GatedGCNConv, TWIRLSConv,
AtomicConv, EGNNConv and GroupRevRes against their ``dgl_tpu``
counterparts, one parametrised test; TWIRLS's attention on its own test
(a graph without self-loops, see there).

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
from dgl_tpu.nn.conv import dgnconv as jdgn, pnaconv as jpna
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
# pseudo-coordinates, "eig" (N, 3) eigenvector columns, "coord" (N, 3)
# coordinates, "d" (E, 1) distances; "atoms" takes the input's place with
# (N, 1) atomic numbers
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
    # mean 1 B1, std 2 (the means of h and h * h), max and min none
    "pna": (lambda: jc.PNAConv(F, O),
            lambda: tc.PNAConv(F, O, device="cpu"), (), (3, 0)),
    "pna_sum_var_moment3_residual": (
        lambda: jc.PNAConv(F, F, ("sum", "var", "moment3"),
                           ("identity", "attenuation"), delta=1.5),
        lambda: tc.PNAConv(F, F, ("sum", "var", "moment3"),
                           ("identity", "attenuation"), delta=1.5,
                           device="cpu"), (), (4, 1)),
    "pna_edge": (lambda: jc.PNAConv(F, O, ("mean", "max"), edge_feat_size=FE),
                 lambda: tc.PNAConv(F, O, ("mean", "max"), edge_feat_size=FE,
                                    device="cpu"), ("e",), (0, 1)),
    "pna_tower": (lambda: jpna.PNAConvTower(F, O),
                  lambda: tc.PNAConvTower(F, O, device="cpu"), (), (3, 0)),
    # mean 1 B1; |F|'s copy_e sum, then a u_mul_e sum per dir aggregator
    "dgn": (lambda: jc.DGNConv(F, O),
            lambda: tc.DGNConv(F, O, device="cpu"), ("eig",), (1, 3)),
    "dgn_tower": (lambda: jdgn.DGNConvTower(
                      F, O, ("sum", "max", "dir2-av"),
                      ("identity", "amplification")),
                  lambda: tc.DGNConvTower(F, O, ("sum", "max", "dir2-av"),
                                          ("identity", "amplification"),
                                          device="cpu"), ("eig",), (1, 2)),
    "gatedgcn": (lambda: jc.GatedGCNConv(F, FE, O),
                 lambda: tc.GatedGCNConv(F, FE, O, device="cpu"), ("e",),
                 (0, 2)),
    "gatedgcn_residual_no_norm": (
        lambda: jc.GatedGCNConv(F, F, F, batch_norm=False),
        lambda: tc.GatedGCNConv(F, F, F, batch_norm=False, device="cpu"),
        ("eF",), (0, 2)),
    "twirls": (lambda: jc.TWIRLSConv(F, O, 16, prop_step=4),
               lambda: tc.TWIRLSConv(F, O, 16, prop_step=4, device="cpu"),
               (), (4, 0)),
    "atomic": (lambda: jc.AtomicConv((2.0, 3.0, 4.0), (0.5, 1.5, 2.5),
                                     (1.0, 2.0, 4.0)),
               lambda: tc.AtomicConv((2.0, 3.0, 4.0), (0.5, 1.5, 2.5),
                                     (1.0, 2.0, 4.0)), ("atoms", "d"),
               (0, 1)),
    "atomic_types": (lambda: jc.AtomicConv((2.0, 3.0), (0.5, 1.5),
                                           (1.0, 2.0), (1.0, 6.0, 8.0)),
                     lambda: tc.AtomicConv((2.0, 3.0), (0.5, 1.5),
                                           (1.0, 2.0), (1.0, 6.0, 8.0)),
                     ("atoms", "d"), (0, 1)),
    "egnn": (lambda: jc.EGNNConv(F, 16, O, edge_feat_size=FE),
             lambda: tc.EGNNConv(F, 16, O, edge_feat_size=FE, device="cpu"),
             ("coord", "e"), (0, 2)),
    "grouprevres_graphconv": (
        lambda: jc.GroupRevRes(lambda i: jc.GraphConv(F // 2, F // 2), 2),
        lambda: tc.GroupRevRes(lambda i: tc.GraphConv(F // 2, F // 2,
                                                      device="cpu"), 2),
        (), (2, 0)),
}

# flax names a module that a factory builds by its class: the port keeps
# the groups' modules in ``gnns``
RENAME = {"grouprevres_graphconv": {"GraphConv_0": "gnns.0",
                                    "GraphConv_1": "gnns.1"}}


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
        elif k in ("eig", "coord"):
            out.append(_rand((N, 3), 14))
        elif k == "d":
            out.append(rng.uniform(0.3, 4.5, (E, 1)).astype(np.float32))
        elif k == "atoms":
            out.append(rng.choice([1.0, 6.0, 7.0, 8.0], (N, 1)).astype(
                np.float32))
    return out


def _call_args(kinds, g, x, extras, to):
    """The layer's positional arguments (edge weights by keyword)."""
    args, kw = [g, x], {}
    for k, v in zip(kinds, extras):
        if k == "w":
            kw["edge_weight"] = to(v)
        elif k != "atoms":  # atoms stand in for the input, x
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
    _check_case(name, CASES[name], graphs[planned], planned, counted)


def _check_case(name, case, graph_pair, planned, counted):
    jfac, tfac, kinds, (n_b1, n_b1w) = case
    jg, tg = graph_pair
    E = tg._relation().num_edges_padded
    x = _rand((N, F), 1)
    extras = _extras(kinds, E)
    if "atoms" in kinds:
        x = extras[kinds.index("atoms")]
    jmod, tmod = jfac(), tfac().eval()
    jargs = lambda xx: _call_args(kinds, jg, xx, extras, jnp.asarray)  # noqa
    targs = lambda xx: _call_args(kinds, tg, xx, extras,  # noqa: E731
                                  torch.from_numpy)
    params = _params(jmod, jargs, x)
    rename = RENAME.get(name)
    sd = dt.from_flax_params(params.get("params", {}), rename)
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
    loss = sum((o * torch.from_numpy(c)).sum() for o, c in zip(outs, cots))
    if loss.requires_grad:  # AtomicConv has no parameter
        loss.backward()
    rtol = 2e-2 if planned else 1e-4

    def close(got, want, what):
        want = np.asarray(want)
        np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                                   atol=rtol * max(np.abs(want).max(),
                                                   1e-30), err_msg=what)

    assert len(outs) == len(ref)
    for i, (o, r) in enumerate(zip(outs, ref)):
        close(o.detach().numpy(), r, f"{name} out {i}")
    # an input read only by comparisons (AtomicConv's atoms) has no
    # gradient: the reference's is 0
    close(np.zeros(x.shape, np.float32) if xt.grad is None
          else xt.grad.numpy(), gx, f"{name} dx")
    want = dt.from_flax_params(gp.get("params", {}), rename)
    got = {k: p.grad for k, p in tmod.named_parameters()}
    assert set(want) == set(got), (set(want), set(got))
    for k, v in want.items():
        g = (np.zeros(v.shape, np.float32) if got[k] is None
             else got[k].numpy())
        close(g, v.numpy(), f"{name} grad {k}")


@pytest.fixture(scope="module")
def loopless():
    """The zoo's edges without self-loops, plain and planned."""
    src, dst = _edges()
    keep = src != dst
    src, dst = src[keep], dst[keep]
    jg = dgl_tpu.graph((src, dst), num_nodes=N)
    tg = dt.graph((src, dst), num_nodes=N, device="cpu")
    kw = dict(num_hubs=8, weighted=True, bitmap=False, dense_attn=False)
    return {False: (jg, tg),
            True: (jg.with_spmm_plans(**kw), tg.with_spmm_plans(**kw))}


TWIRLS_ATTN = (lambda: jc.TWIRLSConv(F, O, 16, prop_step=4, attention=True),
               lambda: tc.TWIRLSConv(F, O, 16, prop_step=4, attention=True,
                                     device="cpu"), (), (3, 1))


@pytest.mark.parametrize("planned", [False, True], ids=["plain", "planned"])
def test_twirls_attention_matches(loopless, counted, planned):
    """TWIRLSConv with attention: 3 ``copy_u`` steps (B1), then the
    reweighted step (B1w), on a graph without self-loops. The reference's
    distance is ``jnp.linalg.norm``, whose gradient at 0 (a self-loop) is
    NaN; the port's ``vector_norm`` gives 0 there (ROADMAP queue C)."""
    _check_case("twirls_attention", TWIRLS_ATTN, loopless[planned], planned,
                counted)


def test_twirls_attention_self_loop_gradient(graphs):
    """On the graph with self-loops the port's gradients stay finite."""
    tg = graphs[False][1]
    mod = TWIRLS_ATTN[1]()
    x = torch.from_numpy(_rand((N, F), 1)).requires_grad_()
    mod(tg, x).sum().backward()
    assert torch.isfinite(x.grad).all()
    assert all(torch.isfinite(p.grad).all() for p in mod.parameters())
