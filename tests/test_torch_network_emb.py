"""The port's DeepWalk and MetaPath2Vec (``dgl_tpu_torch.nn``) against
``dgl_tpu.nn.network_emb``.

Both draw their walks in ``csrc/host_ops.cpp`` (uniform walks) or the
same host loop (metapath walks) from the same numpy generator, and their
negatives after it, so the (target, context, negative) batches are held
exactly. The tables are carried across with ``from_flax_params``
(``node_embed`` / ``context_embed``, seeded numpy values, the context table
not zero so every gradient is), and the loss, both tables' gradients and
the tables after one SGD step held at rtol = 1e-5, atol = 1e-6 * max|ref|
(f32 dot products and means in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dgl_tpu
from dgl_tpu.nn.network_emb import DeepWalk as JDeepWalk
from dgl_tpu.nn.network_emb import MetaPath2Vec as JMetaPath2Vec
import dgl_tpu_torch as dt
from dgl_tpu_torch.nn import DeepWalk, MetaPath2Vec

from test_torch_graph_utils import assert_same
from test_torch_sampling import homo_graphs, reference_native


@pytest.fixture(autouse=True, scope="module")
def _reference_native():
    reference_native()


def _tables(n, dim, seed):
    rng = np.random.default_rng(seed)
    return {"params": {
        "node_embed": {"embedding": rng.random((n, dim)).astype(np.float32)},
        "context_embed": {"embedding": rng.normal(
            scale=0.1, size=(n, dim)).astype(np.float32)}}}


def _step_matches(jm, tm, params, batch, tbatch):
    """The loss, the gradients and the tables after one SGD step (lr 0.5)
    on both sides."""
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    loss, grads = jax.value_and_grad(
        lambda p: jm.apply(p, *[jnp.asarray(a) for a in batch]))(jparams)
    tm.load_state_dict(dt.from_flax_params(params))
    opt = torch.optim.SGD(tm.parameters(), lr=0.5)
    tloss = tm(*tbatch)
    tloss.backward()
    tgrads = {k: p.grad.clone() for k, p in tm.named_parameters()}
    opt.step()
    new = jax.tree_util.tree_map(lambda p, g: p - 0.5 * g, jparams, grads)

    def close(got, want, what):
        want = np.asarray(want)
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-6 * max(np.abs(want).max(), 1e-30),
                                   err_msg=what)

    close(tloss.item(), loss, "loss")
    for tree, got in ((grads, tgrads), (new, dict(tm.state_dict()))):
        want = dt.from_flax_params(tree)
        assert set(got) == set(want) == {"node_embed.weight",
                                         "context_embed.weight"}
        for k, v in got.items():
            close(v.detach().numpy(), want[k].numpy(), k)


@pytest.mark.parametrize("kw", [dict(), dict(window_size=2, negative_size=3,
                                             neg_weight=0.5)])
def test_deepwalk_matches(kw):
    jg, tg = homo_graphs(120, 900, seed=40)
    n, dim = 120, 16
    jm = JDeepWalk(num_nodes=n, emb_dim=dim, walk_length=8, **kw)
    tm = DeepWalk(n, emb_dim=dim, walk_length=8, device="cpu", **kw)
    seeds = np.array([0, 5, 9, 117, 118, 119])  # the last ones: sinks
    batch = jm.sample_batch(jg, seeds, np.random.default_rng(41))
    tbatch = tm.sample_batch(tg, torch.from_numpy(seeds),
                             np.random.default_rng(41))
    assert all(t.dtype == torch.int64 for t in tbatch)
    assert_same(tbatch, batch)
    _step_matches(jm, tm, _tables(n, dim, 42), batch, tbatch)


def test_deepwalk_init_and_table_names():
    """The tables start as the reference's do: node_embed uniform in
    [0, 1), context_embed zero."""
    tm = DeepWalk(50, emb_dim=8, generator=torch.Generator().manual_seed(0),
                  device="cpu")
    w = tm.node_embed.weight.detach()
    assert w.shape == (50, 8) and 0.0 <= w.min() and w.max() < 1.0
    assert w.std() > 0.2
    assert not tm.context_embed.weight.detach().any()
    jm = JDeepWalk(num_nodes=50, emb_dim=8)
    params = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros(3, jnp.int32), jnp.zeros(3, jnp.int32),
                            jnp.zeros((3, 1), jnp.int32))
    assert set(dt.from_flax_params(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), params))) == set(
            tm.state_dict())


def test_metapath2vec_matches():
    rng = np.random.default_rng(43)
    au = (rng.integers(0, 30, 120), rng.integers(0, 20, 120))
    data = {("author", "writes", "paper"): au,
            ("paper", "written-by", "author"): (au[1], au[0])}
    counts = {"author": 30, "paper": 20}
    jg = dgl_tpu.heterograph(data, counts)
    tg = dt.heterograph(data, counts, device="cpu")
    path = ["writes", "written-by"] * 3
    offs, total = JMetaPath2Vec.type_offsets(jg)
    assert (offs, total) == MetaPath2Vec.type_offsets(tg)
    jm = JMetaPath2Vec(num_nodes_total=total, emb_dim=8, window_size=2,
                       negative_size=2)
    tm = MetaPath2Vec(total, emb_dim=8, window_size=2, negative_size=2,
                      device="cpu")
    seeds = np.arange(0, 30, 4)
    batch = jm.sample_batch(jg, seeds, path, np.random.default_rng(44))
    tbatch = tm.sample_batch(tg, seeds, path, np.random.default_rng(44))
    assert_same(tbatch, batch)
    _step_matches(jm, tm, _tables(total, 8, 45), batch, tbatch)
