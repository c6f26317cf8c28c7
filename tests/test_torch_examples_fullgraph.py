"""The port's full-graph example programs (``dgl_tpu_torch/examples/``)
against the JAX package's scripts (``examples/``).

For each script: its data, built by the port's setup functions on the
CPU, equals the JAX script's, built from the script's own lines, exactly
(integer frames may be int64 where the reference has int32); the first
step's loss and every gradient agree within rtol = 1e-4, atol = 1e-4 *
max|ref| (the same f32 operations in another order), with the JAX
script's flax parameters carried into the port's modules by
``from_flax_params``; then the port's ``main([..., "--device", "cpu"])``
runs end to end at a few epochs, its losses finite and falling. Neither
side attaches a plan on the CPU. Dropout is off in the first step on
both sides (the two packages draw other masks). The inline flax models
come from ``runpy.run_path(script, run_name="ref")``, which does not
call ``main``.

Also: every script stops with an error naming CUDA without a card, and
``python -m dgl_tpu_torch.examples.gcn_cora`` runs in a process that
imports no JAX.
"""
import os
import runpy
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as fnn

import dgl_tpu as jdgl
import dgl_tpu.data as J
import dgl_tpu_torch as dt
import dgl_tpu_torch.data as T
from dgl_tpu_torch.examples import (fullgraph_gat_bitmap, gat_citeseer,
                                    gcn_cora, gin_graph_classification,
                                    link_prediction, reddit_fullgraph_gcn,
                                    rgcn_hetero, tree_lstm)
from dgl_tpu_torch.examples._common import masked_cross_entropy

from test_torch_data import same_array, same_graph

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-4
CPU = ["--device", "cpu"]


@pytest.fixture(autouse=True, scope="module")
def _download_dir(tmp_path_factory):
    """Both packages' dataset caches in one temporary directory."""
    saved = os.environ.get("DGL_TPU_DOWNLOAD_DIR")
    os.environ["DGL_TPU_DOWNLOAD_DIR"] = str(tmp_path_factory.mktemp("dl"))
    yield
    if saved is None:
        os.environ.pop("DGL_TPU_DOWNLOAD_DIR", None)
    else:
        os.environ["DGL_TPU_DOWNLOAD_DIR"] = saved


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The port's ops on one thread: these loops of small ops slow down
    many times over when several test workers' thread pools share the
    host's cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def reference_script(name: str) -> dict:
    """The JAX script's module namespace (its ``main`` not called)."""
    return runpy.run_path(os.path.join(ROOT, "examples", f"{name}.py"),
                          run_name="ref")


def jvg(fn):
    """``fn``'s value and gradient, jitted (eager flax runs op by op)
    with XLA's excess precision off, so that each f32 op rounds as the
    port's does."""
    def run(params):
        return jax.jit(jax.value_and_grad(fn)).lower(params).compile(
            compiler_options={"xla_allow_excess_precision": False})(params)
    return run


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def held_step(loss, model, jloss, jgrads, rename=None):
    """The port's loss (already backpropagated into ``model``) and
    gradients against the reference's, rtol = atol / max|ref| = 1e-4. A
    parameter the loss does not reach has no gradient here and a zero
    one there, or none at all where flax made no parameter for a module
    it never called."""
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=TOL,
                               atol=TOL * abs(float(jloss)))
    ref = dt.from_flax_params(np_tree(jgrads), rename)
    params = dict(model.named_parameters())
    assert set(ref) <= set(params), set(ref) - set(params)
    for k in set(params) - set(ref):
        assert params[k].grad is None, k
    for k, r in ref.items():
        r = r.numpy()
        g = params[k].grad
        g = np.zeros_like(r) if g is None else g.numpy()
        np.testing.assert_allclose(g, r, rtol=TOL,
                                   atol=TOL * np.abs(r).max(), err_msg=k)


def load_flax(model, params, rename=None):
    """``model`` with the flax ``params``; every port parameter without a
    flax counterpart must belong to a module the reference never called
    (``held_step`` checks that it gets no gradient)."""
    model.load_state_dict(dt.from_flax_params(np_tree(params), rename),
                          strict=False)
    return model


def jmasked_ce(logits, labels, mask):
    ls = optax.softmax_cross_entropy_with_integer_labels(logits, labels)
    return (ls * mask).sum() / mask.sum()


def trains(result, key="losses"):
    losses = result[key]
    assert np.all(np.isfinite(losses)), losses
    assert losses[-1] < losses[0], losses
    return losses


# -- gcn_cora.py ------------------------------------------------------------


def test_gcn_cora_data_and_first_step():
    from dgl_tpu.models import GCN as JGCN

    jds = J.CoraGraphDataset()
    jg = jdgl.add_self_loop(jdgl.remove_self_loop(jds[0]))
    tds = T.CoraGraphDataset(device="cpu")
    tg = gcn_cora.recipe_graph(tds[0])
    same_graph(tg, jg, "gcn_cora's graph")
    assert tg._relation(None).hub_plan is None
    feat = jg.ndata["feat"]
    labels = jg.ndata["label"].astype(jnp.int32)
    train = jg.ndata["train_mask"].astype(jnp.float32)
    jmodel = JGCN(feat.shape[1], 16, jds.num_classes)
    params = jmodel.init(jax.random.PRNGKey(0), jg, feat)
    jloss, jgrads = jvg(
        lambda p: jmasked_ce(jmodel.apply(p, jg, feat), labels, train))(
        params)
    model = load_flax(gcn_cora.make_model(feat.shape[1], 16,
                                          tds.num_classes, "cpu"), params)
    model.eval()
    loss = masked_cross_entropy(model(tg, tg.ndata["feat"]),
                                tg.ndata["label"], tg.ndata["train_mask"])
    loss.backward()
    held_step(loss, model, jloss, jgrads)


def test_gcn_cora_main(capsys):
    res = gcn_cora.main(["--epochs", "21"] + CPU)
    assert len(trains(res)) == 21
    out = capsys.readouterr().out
    assert "epoch   0 loss" in out and "epoch  20 loss" in out
    assert "test accuracy" in out
    assert 0.0 <= res["test_accuracy"] <= 1.0


# -- reddit_fullgraph_gcn.py -----------------------------------------------


def test_reddit_gcn_data_first_step_and_main(capsys):
    ref = reference_script("reddit_fullgraph_gcn")
    jds = J.RedditDataset()
    jg = jdgl.add_self_loop(jdgl.remove_self_loop(jdgl.to_simple(jds[0])))
    tds = T.RedditDataset(device="cpu")
    tg0, tg = reddit_fullgraph_gcn.recipe_graph(tds[0])
    assert tg is tg0 and tg._relation(None).bitmap_plan is None
    same_graph(tg, jg, "the Reddit recipe's graph")
    feat = jg.ndata["feat"]
    labels = jg.ndata["label"].astype(jnp.int32)
    train = jg.ndata["train_mask"].astype(jnp.float32)
    GraphConv = ref["GraphConv"]

    class GCN(fnn.Module):  # the script's inline model, its own lines
        @fnn.compact
        def __call__(self, g, x):
            x = GraphConv(feat.shape[1], 16, activation=jax.nn.relu,
                          allow_zero_in_degree=True)(g, x)
            return GraphConv(16, jds.num_classes,
                             allow_zero_in_degree=True)(g, x)

    jmodel = GCN()
    params = jmodel.init(jax.random.PRNGKey(0), jg, feat)
    jloss, jgrads = jvg(
        lambda p: jmasked_ce(jmodel.apply(p, jg, feat), labels, train))(
        params)
    rename = {"GraphConv_0": "conv0", "GraphConv_1": "conv1"}
    model = load_flax(reddit_fullgraph_gcn.make_model(
        feat.shape[1], tds.num_classes, "cpu"), params, rename)
    loss = masked_cross_entropy(model(tg, tg.ndata["feat"]),
                                tg.ndata["label"], tg.ndata["train_mask"])
    loss.backward()
    held_step(loss, model, jloss, jgrads, rename)
    res = reddit_fullgraph_gcn.main(CPU)
    assert len(trains(res)) == 30
    assert "test acc" in capsys.readouterr().out


# -- fullgraph_gat_bitmap.py -----------------------------------------------


def test_bitmap_gat_data_first_step_and_main(capsys):
    ref = reference_script("fullgraph_gat_bitmap")
    jds = J.CoraGraphDataset()
    jg = jdgl.add_self_loop(jdgl.remove_self_loop(jdgl.to_simple(jds[0])))
    tg = fullgraph_gat_bitmap.recipe_graph(
        T.CoraGraphDataset(device="cpu")[0])
    same_graph(tg, jg, "the bitmap GAT recipe's graph")
    assert tg._relation(None).bitmap_plan is None
    feat = jg.ndata["feat"]
    labels = jg.ndata["label"].astype(jnp.int32)
    tr = jg.ndata["train_mask"].astype(jnp.float32)
    jmodel = ref["GAT"](feat.shape[1], jds.num_classes)
    params = jmodel.init(jax.random.PRNGKey(0), jg, feat)
    jloss, jgrads = jvg(
        lambda p: jmasked_ce(jmodel.apply(p, jg, feat), labels, tr))(params)
    rename = {"GATConv_0": "conv0", "GATConv_1": "conv1"}
    model = load_flax(fullgraph_gat_bitmap.make_model(
        feat.shape[1], jds.num_classes, "cpu"), params, rename)
    loss = masked_cross_entropy(model(tg, tg.ndata["feat"]),
                                tg.ndata["label"], tg.ndata["train_mask"])
    loss.backward()
    held_step(loss, model, jloss, jgrads, rename)
    # optax.adamw's first update against the port's optimiser
    tx = optax.adamw(5e-3, weight_decay=5e-4)
    upd, _ = tx.update(jgrads, tx.init(params), params)
    want = dt.from_flax_params(np_tree(optax.apply_updates(params, upd)),
                               rename)
    fullgraph_gat_bitmap.make_optimizer(model).step()
    for k, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[k].numpy(),
                                   rtol=TOL, atol=TOL * float(
                                       want[k].abs().max()), err_msg=k)
    res = fullgraph_gat_bitmap.main(CPU)
    assert len(trains(res)) == 30 and len(res["test_accuracy"]) == 3
    assert "epoch 30: loss" in capsys.readouterr().out


# -- gat_citeseer.py -------------------------------------------------------


def test_gat_citeseer_data_first_step_and_main(capsys):
    from dgl_tpu.models import GAT as JGAT

    jds = J.CiteseerGraphDataset()
    jg = jdgl.add_self_loop(jdgl.remove_self_loop(jds[0]))
    tds = T.CiteseerGraphDataset(device="cpu")
    tg = gat_citeseer.recipe_graph(tds[0])
    same_graph(tg, jg, "gat_citeseer's graph")
    feat = jg.ndata["feat"]
    labels = jg.ndata["label"].astype(jnp.int32)
    train = jg.ndata["train_mask"].astype(jnp.float32)
    jmodel = JGAT(feat.shape[1], 8, jds.num_classes, heads=8)
    params = jmodel.init(jax.random.PRNGKey(0), jg, feat)
    jloss, jgrads = jvg(
        lambda p: jmasked_ce(jmodel.apply(p, jg, feat), labels, train))(
        params)
    model = load_flax(gat_citeseer.make_model(feat.shape[1],
                                              tds.num_classes, "cpu"),
                      params)
    model.eval()
    loss = masked_cross_entropy(model(tg, tg.ndata["feat"]),
                                tg.ndata["label"], tg.ndata["train_mask"])
    loss.backward()
    held_step(loss, model, jloss, jgrads)
    res = gat_citeseer.main(["--epochs", "6"] + CPU)
    assert len(trains(res)) == 6
    assert "train time" in capsys.readouterr().out


# -- rgcn_hetero.py --------------------------------------------------------


def test_rgcn_hetero_data_first_step_and_main(capsys):
    ref = reference_script("rgcn_hetero")
    jds = J.SyntheticHeteroDataset()
    jg = jds[0]
    ds, tg, feats, labels, train_mask, test_mask = rgcn_hetero.load("cpu")
    same_graph(tg, jg, "rgcn_hetero's graph")
    jfeats = {nt: jg._node_frames[nt]["feat"] for nt in jg.ntypes}
    for nt in jg.ntypes:
        same_array(feats[nt], jfeats[nt], nt)
    jlabels = jg._node_frames["paper"]["label"].astype(jnp.int32)
    jtrain = jg._node_frames["paper"]["train_mask"].astype(jnp.float32)
    same_array(train_mask, jtrain, "train mask")
    same_array(test_mask, np.asarray(jg._node_frames["paper"]["test_mask"]),
               "test mask")
    jmodel = ref["HeteroRGCN"](64, 32, jds.num_classes, tuple(jg.etypes))
    params = jmodel.init(jax.random.PRNGKey(0), jg, jfeats)
    jloss, jgrads = jvg(
        lambda p: jmasked_ce(jmodel.apply(p, jg, jfeats)["paper"], jlabels,
                             jtrain))(params)
    rename = {f"l{i}_{et}": f"layer{i}.mods.{et}" for i in (0, 1)
              for et in jg.etypes}
    model = load_flax(rgcn_hetero.make_model(tg, ds.num_classes, "cpu"),
                      params, rename)
    loss = masked_cross_entropy(model(tg, feats)["paper"], labels,
                                train_mask)
    loss.backward()
    held_step(loss, model, jloss, jgrads, rename)
    res = rgcn_hetero.main(["--epochs", "4"] + CPU)
    assert len(trains(res)) == 4
    assert "test accuracy" in capsys.readouterr().out


# -- gin_graph_classification.py -------------------------------------------


def test_gin_data_first_step_and_main(capsys):
    from dgl_tpu.dataloading import GraphDataLoader as JLoader
    from dgl_tpu.models import GIN as JGIN

    jtrain = J.MiniGCDataset(320, 10, 20, seed=0)
    jbg, jy, jm = next(iter(JLoader(jtrain, batch_size=32, shuffle=True,
                                    seed=0)))
    train_ds, loader, test_loader = gin_graph_classification.loaders(
        320, 32, "cpu")
    bg, y, m = batch = next(iter(loader))
    same_graph(bg, jbg, "the first batch")
    same_array(y, jy, "labels")
    same_array(m, jm, "graph mask")
    jx = jbg.in_degrees().astype(jnp.float32)[:, None]
    same_array(gin_graph_classification.node_features(bg), jx, "features")
    jmodel = JGIN(1, 32, jtrain.num_classes, num_layers=3, dropout=0.0)
    params = jmodel.init(jax.random.PRNGKey(0), jbg, jx)

    def jloss_fn(p):
        ls = optax.softmax_cross_entropy_with_integer_labels(
            jmodel.apply(p, jbg, jx), jy)
        w = jm.astype(ls.dtype)
        return (ls * w).sum() / w.sum()

    jloss, jgrads = jvg(jloss_fn)(params)
    model = load_flax(gin_graph_classification.make_model(
        32, train_ds.num_classes, "cpu"), params)
    loss = gin_graph_classification.batch_loss(model, batch)
    loss.backward()
    held_step(loss, model, jloss, jgrads)
    res = gin_graph_classification.main(["--epochs", "3"] + CPU)
    assert len(trains(res)) == 3 and len(res["test_accuracy"]) == 2
    assert "test acc" in capsys.readouterr().out


# -- tree_lstm.py ----------------------------------------------------------


def test_tree_lstm_data_first_step_and_main(capsys):
    ref = reference_script("tree_lstm")
    trees = ref["random_trees"](16, 12, np.random.default_rng(0))
    jforest = jdgl.batch(trees)
    sizes = np.asarray([t.num_nodes() for t in trees])
    jroots = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    jy = jnp.asarray([float(np.asarray(t.ndata["x"]).mean())
                      for t in trees])
    forest, roots, y = tree_lstm.forest_task("cpu")
    same_graph(forest, jforest, "the forest")
    same_array(roots, jroots, "roots")
    same_array(y, jy, "targets")
    TreeLSTMCell = ref["TreeLSTMCell"]

    class Model(fnn.Module):  # the script's inline model, its own lines
        @fnn.compact
        def __call__(self, g, x):
            h = TreeLSTMCell(32, name="cell")(g, x)
            return fnn.Dense(1, name="head")(h)

    jmodel = Model()
    x_all = jforest.ndata["x"]
    params = jmodel.init(jax.random.PRNGKey(0), jforest.local_var(), x_all)

    def jloss_fn(p):
        out = jmodel.apply(p, jforest.local_var(), x_all)
        return ((out[jnp.asarray(jroots), 0] - jy) ** 2).mean()

    jloss, jgrads = jvg(jloss_fn)(params)
    model = load_flax(tree_lstm.make_model("cpu"), params)
    loss = tree_lstm.loss_fn(model, forest, roots, y)
    loss.backward()
    held_step(loss, model, jloss, jgrads)
    res = tree_lstm.main(["--epochs", "5"] + CPU)
    assert len(trains(res)) == 5
    assert "final mse" in capsys.readouterr().out


def test_tree_lstm_cell_through_prop_nodes_topo():
    """The cell's UDFs through ``prop_nodes_topo`` (which also pulls into
    the leaves) give its frontier loop's h within 1e-5."""
    forest, _, _ = tree_lstm.forest_task("cpu")
    cell = tree_lstm.TreeLSTMCell(tree_lstm.X_SIZE, 32,
                                  generator=torch.Generator().manual_seed(3),
                                  device="cpu")
    with torch.no_grad():
        cell.b_iou.normal_(0.0, 0.3,
                           generator=torch.Generator().manual_seed(4))
        want = cell(forest, forest.ndata["x"])
        g = cell.start(forest, forest.ndata["x"])
        dt.prop_nodes_topo(g, *cell.udfs())
    np.testing.assert_allclose(g.ndata["h"].numpy(), want.numpy(),
                               rtol=1e-5, atol=1e-5)


# -- link_prediction.py ----------------------------------------------------


def test_link_prediction_data_first_step_and_main(capsys):
    from dgl_tpu.models import GraphSAGE as JSAGE
    from dgl_tpu.sampling import global_uniform_negative_sampling as jneg

    jg = J.SyntheticDataset(num_nodes=2000, num_edges=16000, num_classes=4,
                            feat_dim=32)[0]
    rel = jg._relation(None)
    jps = np.asarray(rel.src)[: rel.num_edges]
    jpd = np.asarray(rel.dst)[: rel.num_edges]
    g, feat, ps, pd = link_prediction.load("cpu")
    same_graph(g, jg, "link_prediction's graph")
    same_array(ps, jps, "positive sources")
    same_array(pd, jpd, "positive destinations")
    jns, jnd = jneg(jg, jps.shape[0], seed=0)
    ns, nd = dt.sampling.global_uniform_negative_sampling(g, ps.shape[0],
                                                          seed=0)
    same_array(ns, jns, "negative sources")
    same_array(nd, jnd, "negative destinations")
    k = min(ns.shape[0], ps.shape[0])
    jmodel = JSAGE(32, 64, 64, num_layers=2)
    jfeat = jg.ndata["feat"]
    params = jmodel.init(jax.random.PRNGKey(0), jg, jfeat)

    def jloss_fn(p):
        h = jmodel.apply(p, jg, jfeat)
        pos = (h[jps[:k]] * h[jpd[:k]]).sum(-1)
        neg = (h[jns[:k]] * h[jnd[:k]]).sum(-1)
        return (-jax.nn.log_sigmoid(pos).mean()
                - jax.nn.log_sigmoid(-neg).mean())

    jloss, jgrads = jvg(jloss_fn)(params)
    model = load_flax(link_prediction.make_model("cpu"), params)
    loss = link_prediction.loss_fn(model, g, feat, ps[:k], pd[:k], ns[:k],
                                   nd[:k])
    loss.backward()
    held_step(loss, model, jloss, jgrads)
    res = link_prediction.main(["--epochs", "4"] + CPU)
    assert len(trains(res)) == 4
    assert 0.0 <= res["auc"] <= 1.0
    assert "AUC" in capsys.readouterr().out


# -- every script: the device ---------------------------------------------

EXAMPLES = ["cooperative_minibatch", "device_dist_sage",
            "distributed_hetero_rgcn", "distributed_link_prediction",
            "distributed_rgcn_minibatch", "distributed_sage",
            "distributed_sage_minibatch", "fullgraph_gat_bitmap",
            "gat_citeseer", "gcn_cora", "gin_graph_classification",
            "graphbolt_pipeline", "graphsage_minibatch", "link_prediction",
            "reddit_fullgraph_gcn", "rgcn_hetero", "sage_device_sampler",
            "tree_lstm"]


def test_every_script_has_a_counterpart():
    scripts = sorted(f[:-3] for f in os.listdir(os.path.join(ROOT,
                                                             "examples"))
                     if f.endswith(".py"))
    assert scripts == EXAMPLES
    ported = sorted(f[:-3] for f in os.listdir(os.path.join(
        ROOT, "dgl_tpu_torch", "examples")) if f.endswith(".py")
        and not f.startswith("_"))
    assert ported == EXAMPLES


@pytest.mark.parametrize("name", EXAMPLES)
def test_scripts_need_cuda_unless_asked_for_the_cpu(name, monkeypatch):
    import importlib

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = importlib.import_module(f"dgl_tpu_torch.examples.{name}")
    with pytest.raises(SystemExit) as info:
        mod.main([])
    assert "CUDA" in str(info.value), info.value


def test_gcn_cora_runs_as_a_module_without_jax(tmp_path):
    """``python -m dgl_tpu_torch.examples.gcn_cora`` in a fresh process
    that blocks any import of JAX or the JAX package."""
    guard = tmp_path / "sitecustomize.py"
    guard.write_text(
        "import sys\n"
        "class _NoJax:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'flax', "
        "'optax', 'dgl_tpu'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, _NoJax())\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(tmp_path), ROOT]))
    out = subprocess.run(
        [sys.executable, "-m", "dgl_tpu_torch.examples.gcn_cora",
         "--epochs", "2", "--device", "cpu"], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "test accuracy" in out.stdout
