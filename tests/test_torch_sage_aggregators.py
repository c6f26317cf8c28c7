"""SAGEConv's ``gcn``, ``pool`` and ``lstm`` aggregators against
``dgl_tpu``'s, and GraphSAGE over each, on a plain graph and on a
``reorder_for_spmm(num_hubs=8, precision="int8")`` hub-planned one.

Inputs are made with numpy from a seed; the reference's parameters are
drawn with numpy at ``jax.eval_shape``'d shapes and carried over by
``from_flax_params`` (flax's ``OptimizedLSTMCell`` into
``torch.nn.LSTMCell``). Forward values and the gradients of
``sum(out * cot)`` for the input and every parameter are compared, the
reference's from ``jax.grad`` under ``jax.jit`` compiled with
``xla_allow_excess_precision`` off (so its CPU path rounds the hub plan's
gathered rows to bf16, as the port does).

The hub plan runs ``copy_u`` sums and means (kernel B1's wrapper,
``shell_prefix_sum``, for the cold tail, counted here); ``max`` and the
LSTM's UDF reduce take the plain branch (no kernel). Counts in the
forward: ``gcn`` one call a layer, ``pool`` and ``lstm`` none.

Tolerances: rtol = 1e-4, atol = 1e-4 * max|ref| per tensor on the plain
graph, on the planned graph for ``pool`` and ``lstm`` (the same f32
operations; sums and products in other orders), and on the planned graph
for ``gcn`` rtol = 2e-2, atol = 2e-2 * max|ref|, the plan paths' bound
(both sides round gathered rows to bf16, in other orders).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dgl_tpu
from dgl_tpu.models import GraphSAGE as JGraphSAGE
from dgl_tpu.nn import conv as jc
import dgl_tpu_torch as dt
from dgl_tpu_torch.models import GraphSAGE
from dgl_tpu_torch.nn import conv as tc
from dgl_tpu_torch.ops import hub_spmm

N, E, F, O = 300, 1800, 10, 7


def _rand(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.fixture(scope="module")
def graphs():
    rng = np.random.default_rng(0)
    src = np.minimum(rng.zipf(1.5, E) - 1, N - 1)
    dst = rng.integers(0, N, E)
    jg = dgl_tpu.graph((src, dst), num_nodes=N)
    tg = dt.graph((src, dst), num_nodes=N, device="cpu")
    kw = dict(num_hubs=8, precision="int8")
    jp, jperm = dgl_tpu.transforms.reorder_for_spmm(jg, **kw)
    tp, tperm = dt.transforms.reorder_for_spmm(tg, **kw)
    np.testing.assert_array_equal(jperm, tperm)
    assert tp._relation().hub_plan is not None
    return {False: (jg, tg), True: (jp, tp)}


@pytest.fixture
def b1_calls(monkeypatch):
    calls = [0]
    orig = hub_spmm.shell_prefix_sum

    def count(*a, **k):
        calls[0] += 1
        return orig(*a, **k)

    monkeypatch.setattr(hub_spmm, "shell_prefix_sum", count)
    return calls


def _params(jmod, args):
    """The reference's parameters at ``init``'s shapes (traced), drawn
    with numpy from a seed."""
    shapes = jax.eval_shape(lambda k: jmod.init(k, *args),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(7)
    return jax.tree_util.tree_map(
        lambda s: jnp.asarray((rng.normal(size=s.shape) * 0.4).astype(
            np.float32)), shapes)


def _check(jmod, tmod, jg, tg, x, tol, b1_calls, n_b1, edge_weight=None):
    ew = None if edge_weight is None else jnp.asarray(edge_weight)
    params = _params(jmod, (jg, jnp.asarray(x), ew))
    sd = dt.from_flax_params(params)
    assert set(sd) == set(tmod.state_dict())
    tmod.load_state_dict(sd)
    out_shape = jax.eval_shape(lambda p: jmod.apply(p, jg, jnp.asarray(x),
                                                    ew), params).shape
    cot = _rand(out_shape, 20)

    def loss(p, xx):
        out = jmod.apply(p, jg, xx, ew)
        return jnp.sum(out * cot), out

    step = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))
    (_, ref), (gp, gx) = step.lower(params, jnp.asarray(x)).compile(
        compiler_options={"xla_allow_excess_precision": False})(
        params, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    b1_calls[0] = 0
    out = tmod(tg, xt, *(() if edge_weight is None
                         else (torch.from_numpy(edge_weight),)))
    assert b1_calls[0] == n_b1, b1_calls
    (out * torch.from_numpy(cot)).sum().backward()

    def close(got, want, what):
        want = np.asarray(want)
        np.testing.assert_allclose(got, want, rtol=tol,
                                   atol=tol * max(np.abs(want).max(), 1e-30),
                                   err_msg=what)

    close(out.detach().numpy(), ref, "out")
    close(xt.grad.numpy(), gx, "dx")
    want = dt.from_flax_params(gp)
    got = dict(tmod.named_parameters())
    assert set(want) == set(got)
    for k, v in want.items():
        close(got[k].grad.numpy(), v.numpy(), f"grad {k}")


# aggregator -> B1 calls a forward on the planned graph
AGGS = {"gcn": 1, "pool": 0, "lstm": 0}


@pytest.mark.parametrize("planned", [False, True], ids=["plain", "planned"])
@pytest.mark.parametrize("agg", list(AGGS))
@pytest.mark.parametrize("widths", [(F, O), (O, F)], ids=["narrowing",
                                                          "widening"])
def test_sageconv_aggregator_matches(graphs, b1_calls, agg, planned,
                                     widths):
    """One layer; ``narrowing`` (in > out) projects before a ``gcn``
    aggregation, ``widening`` after it."""
    jg, tg = graphs[planned]
    fin, fout = widths
    tol = 2e-2 if planned and agg == "gcn" else 1e-4
    _check(jc.SAGEConv(fin, fout, agg),
           tc.SAGEConv(fin, fout, agg, device="cpu"), jg, tg,
           _rand((N, fin), 1), tol, b1_calls, AGGS[agg] if planned else 0)


@pytest.mark.parametrize("agg", ["gcn", "lstm"])
def test_sageconv_edge_weight_matches(graphs, b1_calls, agg):
    """``u_mul_e`` messages (the plain branch: no kernel)."""
    jg, tg = graphs[False]
    w = np.random.default_rng(3).uniform(0.5, 1.5, E).astype(np.float32)
    _check(jc.SAGEConv(F, O, agg), tc.SAGEConv(F, O, agg, device="cpu"),
           jg, tg, _rand((N, F), 1), 1e-4, b1_calls, 0, edge_weight=w)


@pytest.mark.parametrize("planned", [False, True], ids=["plain", "planned"])
@pytest.mark.parametrize("agg", list(AGGS))
def test_graphsage_aggregator_matches(graphs, b1_calls, agg, planned):
    """GraphSAGE 10 -> 16 -> 16 -> 7 (eval): ``gcn`` launches B1's
    wrapper once a layer on the planned graph."""
    jg, tg = graphs[planned]
    tol = 2e-2 if planned and agg == "gcn" else 1e-4
    jmod = JGraphSAGE(F, 16, O, num_layers=3, aggregator_type=agg)
    tmod = GraphSAGE(F, 16, O, num_layers=3, aggregator_type=agg,
                     device="cpu").eval()

    class _Call:  # the reference model takes no edge weight
        def __init__(self, m):
            self.m = m

        def init(self, k, g, x, ew):
            return self.m.init(k, g, x)

        def apply(self, p, g, x, ew):
            return self.m.apply(p, g, x)

    _check(_Call(jmod), tmod, jg, tg, _rand((N, F), 1), tol, b1_calls,
           3 * AGGS[agg] if planned else 0)


def test_lstm_reduce_masks_and_orders():
    """The LSTM reduce against a per-node loop over each node's real
    messages in order: nodes of in-degree 0, 1 and the maximum."""
    from dgl_tpu_torch.nn.conv.sageconv import _lstm_reduce

    torch.manual_seed(0)
    cell = torch.nn.LSTMCell(4, 4)
    deg = torch.tensor([0, 3, 1, 5, 2, 5])
    m = torch.randn(6, 5, 4)
    mask = torch.arange(5)[None, :] < deg[:, None]
    m = m * mask.unsqueeze(-1)
    got = _lstm_reduce(cell, m, mask)
    for i, d in enumerate(deg.tolist()):
        h = c = torch.zeros(1, 4)
        for t in range(d):
            h, c = cell(m[i, t:t + 1], (h, c))
        torch.testing.assert_close(got[i:i + 1], h, rtol=1e-6, atol=1e-6)
    # no node with a message: every carry stays 0
    torch.testing.assert_close(
        _lstm_reduce(cell, torch.zeros_like(m), torch.zeros_like(mask)),
        torch.zeros(6, 4))
