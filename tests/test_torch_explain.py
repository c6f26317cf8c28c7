"""The port's explainers (``dgl_tpu_torch.nn.explain``) against
``dgl_tpu.nn.explain``, on the same numpy graphs, features and weights.

The models are two ``GraphConv`` layers (one a relation on the
heterographs) that take the explainers' edge weights, the same weights
on both sides: the reference's flax modules are applied to numpy
parameters, the port's modules load them.

- GNNExplainer and HeteroGNNExplainer draw their initial masks from the
  same numpy generator, and ``torch.optim.Adam`` makes ``optax.adam``'s
  update: the masks after a fixed number of epochs are held at
  rtol = 1e-4, atol = 1e-4 * max|ref|. Few epochs (5): Adam divides each
  step by the root of the squared gradient, which for an entry whose
  gradient is near 0 turns rounding differences into whole steps.
- PGExplainer and HeteroPGExplainer: JAX's key stream cannot be
  reproduced, so each test replaces the noise draw on both sides with the
  same numpy table (``jax.random.uniform`` looked up by key in the
  reference, ``_uniform_noise`` in the port); the losses, trained MLP
  weights, probabilities and masks are held at 1e-4 of max|ref|.
- SubgraphX and HeteroSubgraphX draw their coalitions from the same numpy
  generator: on these models (no near-ties among the scores, checked by
  the result) the node sets are equal and the scores agree at 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dgl_tpu
from dgl_tpu.nn.conv import GraphConv as JGraphConv
from dgl_tpu.nn.explain import (GNNExplainer as JGNNExplainer,
                                HeteroGNNExplainer as JHeteroGNNExplainer,
                                HeteroPGExplainer as JHeteroPGExplainer,
                                HeteroSubgraphX as JHeteroSubgraphX,
                                PGExplainer as JPGExplainer,
                                SubgraphX as JSubgraphX)
from dgl_tpu.nn.hetero import _relation_view as jview
import dgl_tpu_torch as dt
from dgl_tpu_torch.nn import GraphConv
from dgl_tpu_torch.nn.explain import (GNNExplainer, HeteroGNNExplainer,
                                      HeteroPGExplainer, HeteroSubgraphX,
                                      PGExplainer, SubgraphX)
from dgl_tpu_torch.nn.explain import hetero_pgexplainer, pgexplainer
from dgl_tpu_torch.nn.hetero import _relation_view as tview

from test_torch_graph_utils import np_of, same_graph

IN, HID, OUT = 5, 8, 3


def close(got, ref, what, tol=1e-4):
    r, g = np.asarray(ref), np_of(got)
    assert g.shape == r.shape, (what, g.shape, r.shape)
    np.testing.assert_allclose(g, r, rtol=tol,
                               atol=tol * max(float(np.abs(r).max()), 1e-30),
                               err_msg=what)


def conv_weights(dims, seed):
    rng = np.random.default_rng(seed)
    return [(rng.normal(0, 0.5, (a, b)).astype(np.float32),
             rng.normal(0, 0.1, b).astype(np.float32))
            for a, b in zip(dims[:-1], dims[1:])]


def jconv(w, b):
    """A reference GraphConv applied to numpy weights."""
    mod = JGraphConv(w.shape[0], w.shape[1], allow_zero_in_degree=True)
    params = {"params": {"weight": jnp.asarray(w), "bias": jnp.asarray(b)}}
    return lambda g, x, ew: mod.apply(params, g, x, edge_weight=ew)


def tconv(w, b):
    mod = GraphConv(w.shape[0], w.shape[1], allow_zero_in_degree=True,
                    device="cpu")
    mod.weight.data = torch.from_numpy(w)
    mod.bias.data = torch.from_numpy(b)
    return mod


def homo_graphs(n=24, e=90, seed=0):
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    x = rng.normal(size=(n, IN)).astype(np.float32)
    return (dgl_tpu.graph((src, dst), num_nodes=n), jnp.asarray(x),
            dt.graph((src, dst), num_nodes=n, device="cpu"),
            torch.from_numpy(x))


def homo_models(seed=1, graph_level=False, with_emb=False):
    """Two GraphConv layers (ReLU between) on both sides; node logits, or
    the graph's mean logits as (1, C); ``with_emb`` also returns the
    hidden layer, PGExplainer's node embeddings."""
    (w0, b0), (w1, b1) = conv_weights((IN, HID, OUT), seed)
    j0, j1 = jconv(w0, b0), jconv(w1, b1)
    t0, t1 = tconv(w0, b0), tconv(w1, b1)

    def jmodel(g, x, ew):
        h = jax.nn.relu(j0(g, x, ew))
        out = j1(g, h, ew)
        out = out.mean(0, keepdims=True) if graph_level else out
        return (out, h) if with_emb else out

    def tmodel(g, x, ew):
        h = torch.relu(t0(g, x, ew))
        out = t1(g, h, ew)
        out = out.mean(0, keepdim=True) if graph_level else out
        return (out, h) if with_emb else out

    return jmodel, tmodel


# ---------------------------------------------------------------------------
# GNNExplainer
# ---------------------------------------------------------------------------

EPOCHS = 5  # few: see the module docstring


def test_gnnexplainer_explain_graph():
    jg, jx, tg, tx = homo_graphs()
    jm, tm = homo_models(graph_level=True)
    jfm, jem = JGNNExplainer(jm, 2, num_epochs=EPOCHS).explain_graph(jg, jx)
    tfm, tem = GNNExplainer(tm, 2, num_epochs=EPOCHS).explain_graph(tg, tx)
    close(tfm, jfm, "feature mask")
    close(tem, jem, "edge mask")


@pytest.mark.parametrize("node", [0, 7])
def test_gnnexplainer_explain_node(node):
    jg, jx, tg, tx = homo_graphs(seed=2)
    jm, tm = homo_models(seed=3)
    jid, jsg, jfm, jem = JGNNExplainer(jm, 2, num_epochs=EPOCHS,
                                       seed=4).explain_node(node, jg, jx)
    tid, tsg, tfm, tem = GNNExplainer(tm, 2, num_epochs=EPOCHS,
                                      seed=4).explain_node(node, tg, tx)
    assert tid == jid
    same_graph(tsg, jsg, "the k-hop subgraph", batch=False)
    close(tfm, jfm, "feature mask")
    close(tem, jem, "edge mask")


def test_gnnexplainer_first_loss_and_gradients():
    """The first epoch's loss and mask gradients, the chip check's
    comparison, against ``jax.value_and_grad`` of the reference loss."""
    jg, jx, tg, tx = homo_graphs(seed=5)
    jm, tm = homo_models(seed=6, graph_level=True)
    je, te = JGNNExplainer(jm, 2), GNNExplainer(tm, 2)
    target = np.array([1])
    masks = te._init_masks(tg, tx)
    for m in masks:
        m.requires_grad_(True)
    loss = te._loss(masks, tg, tx, torch.from_numpy(target))
    loss.backward()
    jmasks = tuple(jnp.asarray(np_of(m)) for m in masks)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda m: je._loss(m, jg, jx, jnp.asarray(target))))(jmasks)
    close(loss.detach(), jloss, "loss")
    close(masks[0].grad, jgrads[0], "edge mask gradient")
    close(masks[1].grad, jgrads[1], "feature mask gradient")


# ---------------------------------------------------------------------------
# heterographs
# ---------------------------------------------------------------------------

HETERO = {("a", "ab", "b"): (8, 6, 30), ("b", "ba", "a"): (6, 8, 20),
          ("a", "aa", "a"): (8, 8, 16)}


def hetero_graphs(seed=0):
    rng = np.random.default_rng(seed)
    data = {cet: (rng.integers(0, ns, e), rng.integers(0, nd, e))
            for cet, (ns, nd, e) in HETERO.items()}
    nodes = {"a": 8, "b": 6}
    x = {nt: rng.normal(size=(n, IN)).astype(np.float32)
         for nt, n in nodes.items()}
    return (dgl_tpu.heterograph(data, nodes),
            {k: jnp.asarray(v) for k, v in x.items()},
            dt.heterograph(data, nodes, device="cpu"),
            {k: torch.from_numpy(v) for k, v in x.items()})


def hetero_models(seed=1, graph_level=False, with_emb=False):
    """A GraphConv a relation, summed into the destination type, two
    layers (ReLU between), the edge weights a relation's
    ``edge_weight``; logits of type ``a``."""
    layers = [{et: conv_weights((a, b), s + i)[0]
               for i, et in enumerate(("ab", "ba", "aa"))}
              for (a, b), s in (((IN, HID), seed), ((HID, OUT), seed + 7))]

    def make(conv, view, relu):
        mods = [{et: conv(*wb) for et, wb in layer.items()}
                for layer in layers]

        def layer(i, g, x, ew):
            out = {}
            for cet in g.canonical_etypes:
                st, et, dst = cet
                if st in x:
                    r = mods[i][et](view(g, cet), (x[st], x.get(dst)),
                                    ew[cet])
                    out[dst] = r if dst not in out else out[dst] + r
            return out

        def model(g, x, ew):
            h = {k: relu(v) for k, v in layer(0, g, x, ew).items()}
            out = layer(1, g, h, ew)["a"]
            out = out.mean(0, keepdims=True) if graph_level else out
            return (out, h) if with_emb else out

        return model

    return (make(jconv, jview, jax.nn.relu),
            make(tconv, tview, torch.relu))


def test_hetero_gnnexplainer_explain_graph():
    jg, jx, tg, tx = hetero_graphs()
    jm, tm = hetero_models(graph_level=True)
    jfm, jem = JHeteroGNNExplainer(jm, 1, num_epochs=EPOCHS).explain_graph(
        jg, jx)
    tfm, tem = HeteroGNNExplainer(tm, 1, num_epochs=EPOCHS).explain_graph(
        tg, tx)
    assert set(tfm) == set(jfm) and set(tem) == set(jem)
    for k in jfm:
        close(tfm[k], jfm[k], f"feature mask {k}")
    for k in jem:
        close(tem[k], jem[k], f"edge mask {k}")


def test_hetero_gnnexplainer_explain_node():
    jg, jx, tg, tx = hetero_graphs(seed=3)
    jm, tm = hetero_models(seed=4)
    jid, jsg, jfm, jem = JHeteroGNNExplainer(
        jm, 2, num_epochs=EPOCHS).explain_node("a", 2, jg, jx)
    tid, tsg, tfm, tem = HeteroGNNExplainer(
        tm, 2, num_epochs=EPOCHS).explain_node("a", 2, tg, tx)
    assert tid == jid
    same_graph(tsg, jsg, "the k-hop subgraph", batch=False)
    assert set(tfm) == set(jfm) and set(tem) == set(jem)
    for k in jfm:
        close(tfm[k], jfm[k], f"feature mask {k}")
    for k in jem:
        close(tem[k], jem[k], f"edge mask {k}")


# ---------------------------------------------------------------------------
# PGExplainer, with the same noise on both sides
# ---------------------------------------------------------------------------

PG_EPOCHS = 4


def shared_noise(monkeypatch, module, keys, width, seed=9):
    """The uniform draws of the ``keys`` (in the order the explainer
    draws them) from one numpy table: the reference's
    ``jax.random.uniform`` finds its key's row, the port's
    ``_uniform_noise`` takes the rows in turn."""
    rng = np.random.default_rng(seed)
    table = rng.uniform(1e-6, 1 - 1e-6, (len(keys), width)).astype(
        np.float32)
    jkeys, jtable = jnp.stack(keys), jnp.asarray(table)

    def fake_uniform(key, shape, minval=0.0, maxval=1.0, **kw):
        row = jnp.argmax(jnp.all(jkeys == key, axis=-1))
        return jtable[row, :int(np.prod(shape))].reshape(shape)

    calls = []

    def fake_noise(gen, shape, device):
        i = len(calls)
        calls.append(shape)
        return torch.from_numpy(table[i, :int(np.prod(shape))]).reshape(
            shape).to(device)

    monkeypatch.setattr(jax.random, "uniform", fake_uniform)
    monkeypatch.setattr(module, "_uniform_noise", fake_noise)
    return calls


def pg_params(in_feats, seed=2):
    rng = np.random.default_rng(seed)
    return {"params": {
        "fc0": {"kernel": rng.normal(0, 0.3, (in_feats, 64)).astype(
            np.float32), "bias": rng.normal(0, 0.1, 64).astype(np.float32)},
        "fc1": {"kernel": rng.normal(0, 0.3, (64, 1)).astype(np.float32),
                "bias": np.zeros(1, np.float32)}}}


def held_net(tex, jex, what):
    got = tex.net.state_dict()
    for name, ref in dt.from_flax_params(jax.tree_util.tree_map(
            np.asarray, jex.params)).items():
        close(got[name], ref, f"{what} {name}")


def test_pgexplainer_matches_with_shared_noise(monkeypatch):
    jg, jx, tg, tx = homo_graphs(seed=6)
    jm, tm = homo_models(seed=7, graph_level=True, with_emb=True)
    key, subs = jax.random.PRNGKey(0), []
    for _ in range(PG_EPOCHS):
        key, sub = jax.random.split(key)
        subs.append(sub)
    calls = shared_noise(monkeypatch, pgexplainer, subs, tg.num_edges())
    params = pg_params(2 * HID)
    jex = JPGExplainer(jm, HID, epochs=PG_EPOCHS)
    jex.params = jax.tree_util.tree_map(jnp.asarray, params)
    tex = PGExplainer(tm, HID, epochs=PG_EPOCHS)
    tex.net.load_state_dict(dt.from_flax_params(params))
    close(tex.train_step(tg, tx), jex.train_step(jg, jx), "loss")
    assert len(calls) == PG_EPOCHS
    held_net(tex, jex, "trained MLP")
    tp, tmask = tex.explain_graph(tg, tx)
    jp, jmask = jex.explain_graph(jg, jx)
    close(tp, jp, "probabilities")
    close(tmask, jmask, "edge mask")


def test_hetero_pgexplainer_matches_with_shared_noise(monkeypatch):
    jg, jx, tg, tx = hetero_graphs(seed=7)
    jm, tm = hetero_models(seed=8, graph_level=True, with_emb=True)
    key, subs = jax.random.PRNGKey(0), []
    for _ in range(PG_EPOCHS):
        key, sub = jax.random.split(key)
        for _cet in jg.canonical_etypes:
            sub, s2 = jax.random.split(sub)
            subs.append(s2)
    calls = shared_noise(monkeypatch, hetero_pgexplainer, subs,
                         max(c[2] for c in HETERO.values()))
    params = pg_params(2 * HID, seed=3)
    jex = JHeteroPGExplainer(jm, HID, epochs=PG_EPOCHS)
    jex.params = jax.tree_util.tree_map(jnp.asarray, params)
    tex = HeteroPGExplainer(tm, HID, epochs=PG_EPOCHS)
    tex.net.load_state_dict(dt.from_flax_params(params))
    close(tex.train_step(tg, tx), jex.train_step(jg, jx), "loss")
    assert len(calls) == PG_EPOCHS * len(HETERO)
    held_net(tex, jex, "trained MLP")
    tp, tmasks = tex.explain_graph(tg, tx)
    jp, jmasks = jex.explain_graph(jg, jx)
    close(tp, jp, "probabilities")
    for cet in jmasks:
        close(tmasks[cet], jmasks[cet], f"edge mask {cet}")


def test_pgexplainer_noise_is_the_seeds():
    """Without the shared table, the port's noise is a function of the
    seed alone: two explainers of one seed train to the same MLP."""
    _, _, tg, tx = homo_graphs(seed=8)
    _, tm = homo_models(seed=9, graph_level=True, with_emb=True)
    a, b = (PGExplainer(tm, HID, epochs=3, seed=5) for _ in range(2))
    assert a.train_step(tg, tx) == b.train_step(tg, tx)
    for (k, v), w in zip(a.net.state_dict().items(),
                         b.net.state_dict().values()):
        assert torch.equal(v, w), k


# ---------------------------------------------------------------------------
# SubgraphX
# ---------------------------------------------------------------------------


def test_subgraphx_matches():
    jg, jx, tg, tx = homo_graphs(n=11, e=30, seed=10)
    jm, tm = homo_models(seed=11, graph_level=True)
    ones_j = jnp.ones(jg.num_edges())
    ones_t = torch.ones(tg.num_edges())
    jfast = jax.jit(lambda x: jm(jg, x, ones_j))
    kw = dict(num_rollouts=6, shapley_steps=5, node_min=2)
    jnodes, jscore = JSubgraphX(lambda g, x: jfast(x), **kw).explain_graph(
        jg, jx, node_max=5)
    tnodes, tscore = SubgraphX(lambda g, x: tm(g, x, ones_t),
                               **kw).explain_graph(tg, tx, node_max=5)
    assert np.array_equal(tnodes, jnodes)
    close(tscore, jscore, "score")


def test_hetero_subgraphx_matches():
    jg, jx, tg, tx = hetero_graphs(seed=11)
    jm, tm = hetero_models(seed=12, graph_level=True)
    ones_j = {c: jnp.ones(jg.num_edges(c)) for c in jg.canonical_etypes}
    ones_t = {c: torch.ones(tg.num_edges(c)) for c in tg.canonical_etypes}
    jfast = jax.jit(lambda x: jm(jg, x, ones_j))
    kw = dict(num_rollouts=5, shapley_steps=4, node_min=2)
    jres, jscore = JHeteroSubgraphX(lambda g, x: jfast(x),
                                    **kw).explain_graph(jg, jx, node_max=6)
    tres, tscore = HeteroSubgraphX(lambda g, x: tm(g, x, ones_t),
                                   **kw).explain_graph(tg, tx, node_max=6)
    assert set(tres) == set(jres)
    for nt in jres:
        assert np.array_equal(tres[nt], jres[nt]), nt
    close(tscore, jscore, "score")
