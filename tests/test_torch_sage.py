"""The port's slice against ``dgl_tpu``: GraphSAGE inference with the same
parameters (carried over by ``from_flax_params``), on a rank-reordered zipf
graph through the hub SpMM, and on the ``entry()`` graph without a plan.

Both sides round the aggregated rows to bf16 and sum them in f32. Where the
two sides aggregate the same table, they agree to f32 rounding of different
summation orders: rtol = atol = 1e-4. Where the table is itself computed
(a layer whose projection runs before the aggregation, and every layer
after the first in the full model), the two frameworks' f32 matmuls differ
in the last bit, and an element that lies on a bf16 rounding boundary can
round to neighbouring bf16 values on the two sides. Such an element is off
by one bf16 step (2**-8 relative) of one aggregated feature. There the
check is: at most 1 element in 1000 outside rtol = atol = 1e-4, and every
element within 2**-8 of the output's largest magnitude.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import dgl_tpu
from dgl_tpu.models import GraphSAGE as JGraphSAGE
import dgl_tpu_torch as dt
from dgl_tpu_torch.models import GraphSAGE


def _assert_close_up_to_bf16_flips(out, ref):
    bad = np.abs(out - ref) > 1e-4 + 1e-4 * np.abs(ref)
    assert bad.mean() <= 1e-3, f"{bad.sum()} of {bad.size} elements"
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=2.0 ** -8 * np.abs(ref).max())


def _port_model(params, in_feats, hidden, classes, num_layers):
    model = GraphSAGE(in_feats, hidden, classes, num_layers=num_layers,
                      device="cpu")
    model.load_state_dict(dt.from_flax_params(params))
    return model.eval()


def test_from_flax_params_layout():
    g = dgl_tpu.graph((np.array([0, 1]), np.array([1, 2])), num_nodes=3)
    x = jnp.ones((3, 5))
    params = JGraphSAGE(5, 7, 3, num_layers=2).init(jax.random.PRNGKey(0),
                                                    g, x)
    sd = dt.from_flax_params(params)
    assert sd["sage0.fc_neigh.weight"].shape == (7, 5)
    np.testing.assert_array_equal(
        sd["sage1.fc_self.weight"].numpy(),
        np.asarray(params["params"]["sage1"]["fc_self"]["kernel"]).T)
    assert sd["sage1.bias"].shape == (3,)
    # every parameter of the port's module is covered, and nothing else
    port = GraphSAGE(5, 7, 3, num_layers=2, device="cpu")
    assert set(sd) == set(port.state_dict())


def _zipf_slice(n=20_000, e=120_000, in_feats=16):
    """Reordered zipf graph on both sides. Density 3e-4 stays under the
    bitmap "auto" threshold, so both take the hub path."""
    rng = np.random.default_rng(0)
    w = 1.0 / np.arange(1, n + 1)
    src = rng.choice(n, e, p=w / w.sum())
    dst = rng.integers(0, n, e)
    x = rng.normal(size=(n, in_feats)).astype(np.float32)
    jg, jperm = dgl_tpu.transforms.reorder_for_spmm(
        dgl_tpu.graph((src, dst), num_nodes=n), num_hubs=256,
        precision="int8")
    tg, tperm = dt.transforms.reorder_for_spmm(
        dt.graph((src, dst), num_nodes=n, device="cpu"), num_hubs=256,
        precision="int8")
    np.testing.assert_array_equal(jperm, tperm)
    jrel = jg._relation()
    assert jrel.bitmap_plan is None and jrel.hub_plan is not None
    assert tg._relation().hub_plan is not None
    return jg, tg, x


def test_graphsage_hub_path_matches():
    """3 layers 16 -> 32 -> 32 -> 8: they aggregate at 16, 32 and 8."""
    in_feats, hidden, classes = 16, 32, 8
    jg, tg, x = _zipf_slice(in_feats=in_feats)
    jmodel = JGraphSAGE(in_feats, hidden, classes, num_layers=3)
    params = jmodel.init(jax.random.PRNGKey(1), jg, jnp.asarray(x))
    ref, state = jmodel.apply(params, jg, jnp.asarray(x),
                              capture_intermediates=True)
    ref = np.asarray(ref)
    layer_out = [np.asarray(state["intermediates"][f"sage{i}"]["__call__"][0])
                 for i in range(3)]
    model = _port_model(params, in_feats, hidden, classes, 3)
    with torch.inference_mode():
        # each layer on the reference's own input to that layer
        h = x
        for i, r in enumerate(layer_out):
            conv = getattr(model, f"sage{i}")
            o = conv(tg, torch.from_numpy(h)).numpy()
            if conv.in_feats > conv.out_feats:  # projection before the sum
                _assert_close_up_to_bf16_flips(o, r)
            else:
                np.testing.assert_allclose(o, r, rtol=1e-4, atol=1e-4)
            h = np.maximum(r, 0.0)
        out = model(tg, torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape and np.isfinite(out).all()
    _assert_close_up_to_bf16_flips(out, ref)


def test_entry_graph_without_plan_matches():
    from __graft_entry__ import entry

    fwd, (params, jg, x) = entry()
    ref = np.asarray(fwd(params, jg, x))
    jrel = jg._relation()
    tg = dt.graph((np.asarray(jrel.src), np.asarray(jrel.dst)),
                  num_nodes=jg.num_nodes(), device="cpu")
    assert tg._relation().hub_plan is None
    model = _port_model(params, 64, 128, 16, 2)
    with torch.inference_mode():
        out = model(tg, torch.from_numpy(np.array(x))).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)


def test_port_modules_train_mode_dropout_and_errors():
    g = dt.graph((np.array([0, 1, 2]), np.array([1, 2, 0])), num_nodes=3,
                 device="cpu")
    gen = torch.Generator().manual_seed(0)
    model = GraphSAGE(4, 6, 2, num_layers=2, dropout=0.5, generator=gen,
                      device="cpu")
    x = torch.ones(3, 4)
    model.eval()
    a, b = model(g, x), model(g, x)
    torch.testing.assert_close(a, b)  # eval: dropout off, deterministic
    for agg in ("gcn", "pool", "lstm"):  # ported: no longer raise
        conv = dt.nn.SAGEConv(4, 6, aggregator_type=agg, device="cpu")
        out = conv(g, x)
        assert out.shape == (3, 6) and torch.isfinite(out).all()
    with pytest.raises(dt.DGLError):
        dt.nn.SAGEConv(4, 6, aggregator_type="bogus")
