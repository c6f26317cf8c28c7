"""The port's trainer CLI (``dgl_tpu_torch/cli.py``) against ``dgl_tpu``'s.

- ``recipe list|get`` and ``configure`` print the reference's text.
- ``export`` -> the generated script -> ``apply`` with ``--device cpu``
  (as ``tests/test_cli.py`` does for the reference); the script imports
  torch and the port, no JAX.
- ``apply`` parity: the reference's ``_build_model("gcn", ...)``
  parameters go through its ``save_checkpoint`` and ``_run_apply``; the
  same parameters through ``from_flax_params``, the port's
  ``save_checkpoint`` and the port's ``apply``. The predictions are equal
  but at rows whose top two logits lie within 1e-5.
- Each pipeline's datasets are the reference's, exactly (int64 where the
  reference has int32).
- Each pipeline trains on the CPU: finite losses that fall, GCN on Cora
  above the reference's 0.6 floor (``tests/test_end_to_end.py``).
- Without a card, ``train`` and ``apply`` stop with an error naming CUDA.
"""
import ast
import json
import runpy

import jax
import numpy as np
import pytest
import torch

import dgl_tpu
import dgl_tpu.cli as jcli
from dgl_tpu.checkpoint import save_checkpoint as j_save
import dgl_tpu_torch as dt
import dgl_tpu_torch.cli as tcli

from test_torch_data import same_dataset, same_graph, same_item


@pytest.fixture(autouse=True)
def _download_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("DGL_TPU_DOWNLOAD_DIR", str(tmp_path / "zoo"))


def _printed(main, argv, capsys):
    main(argv)
    return capsys.readouterr().out


TEXT_COMMANDS = (
    [["recipe", "list"]]
    + [["recipe", "get", name] for name in jcli.RECIPES]
    + [["configure", p] for p in ("nodepred", "nodepred-ns", "linkpred",
                                  "graphpred")]
    + [["configure", "nodepred", "--model", "gat", "--dataset", "citeseer",
        "--epochs", "7", "--lr", "0.005", "--hidden", "8"]]
)


@pytest.mark.parametrize("argv", TEXT_COMMANDS, ids=" ".join)
def test_text_commands_print_the_reference_text(argv, capsys):
    ref = _printed(jcli.main, argv, capsys)
    got = _printed(tcli.main, argv, capsys)
    assert got == ref
    # --device is taken, and changes nothing of the text
    assert _printed(tcli.main, argv + ["--device", "cpu"], capsys) == ref


def test_recipes_are_the_reference_recipes():
    assert tcli.RECIPES == jcli.RECIPES


def _imported_roots(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_export_run_apply_roundtrip(tmp_path, capsys):
    """export writes a standalone script; running it trains and saves the
    model's state_dict; apply loads it and writes the predictions."""
    cfg = {"pipeline": "nodepred", "model": "gcn", "dataset": "cora",
           "epochs": 12, "lr": 1e-2, "hidden": 16}
    cfgp = tmp_path / "cfg.json"
    cfgp.write_text(json.dumps(cfg))
    script = tmp_path / "gen.py"
    ck = tmp_path / "ck.npz"
    tcli.main(["export", "--cfg", str(cfgp), "--output", str(script),
               "--checkpoint", str(ck), "--device", "cpu"])
    assert "standalone script" in capsys.readouterr().out
    roots = set(_imported_roots(script))
    assert {"torch", "dgl_tpu_torch"} <= roots
    assert not roots & {"jax", "flax", "optax", "dgl_tpu"}, roots
    runpy.run_path(str(script), run_name="__main__")
    out = capsys.readouterr().out
    assert "test accuracy" in out and "checkpoint saved" in out
    assert ck.exists()
    with np.load(ck) as z:
        assert int(z["__step__"]) == 12
    preds = tmp_path / "preds.npy"
    tcli.main(["apply", "--checkpoint", str(ck), "--model", "gcn",
               "--dataset", "cora", "--output", str(preds),
               "--device", "cpu"])
    assert "predictions for 2708 nodes" in capsys.readouterr().out
    p = np.load(preds)
    assert p.shape == (2708,)
    assert p.dtype.kind in "iu"


@pytest.mark.parametrize("pipeline", ["nodepred-ns", "linkpred",
                                      "graphpred"])
def test_export_rejects_other_pipelines(pipeline, tmp_path):
    cfgp = tmp_path / "cfg.json"
    cfgp.write_text(json.dumps({"pipeline": pipeline}))
    for main in (jcli.main, tcli.main):
        with pytest.raises(SystemExit):
            main(["export", "--cfg", str(cfgp), "--output",
                  str(tmp_path / "x.py")])


def test_apply_matches_the_reference(tmp_path, capsys):
    ds = dgl_tpu.data.CoraGraphDataset()
    g = dgl_tpu.add_self_loop(dgl_tpu.remove_self_loop(ds[0]))
    feat = g.ndata["feat"]
    jmodel = jcli._build_model("gcn", feat.shape[1], 16, ds.num_classes)
    params = jmodel.init(jax.random.PRNGKey(3), g, feat)
    # trained-looking weights: the init's scaled up, so the classes part
    params = jax.tree_util.tree_map(lambda p: p * 4.0, params)
    j_ck, j_out = str(tmp_path / "j.npz"), str(tmp_path / "j.npy")
    j_save(j_ck, params, step=5)
    jcli._run_apply({"model": "gcn", "dataset": "cora", "hidden": 16,
                     "checkpoint": j_ck, "output": j_out})
    ref = np.load(j_out)
    logits = np.asarray(jmodel.apply(params, g, feat))

    tmodel = tcli._build_model("gcn", feat.shape[1], 16, ds.num_classes,
                               device="cpu")
    tmodel.load_state_dict(dt.from_flax_params(params))
    t_ck, t_out = str(tmp_path / "t.npz"), str(tmp_path / "t.npy")
    dt.save_checkpoint(t_ck, tmodel.state_dict(), step=5)
    tcli.main(["apply", "--checkpoint", t_ck, "--output", t_out,
               "--device", "cpu"])
    got = np.load(t_out)
    assert got.shape == ref.shape == (2708,)
    assert got.dtype == np.int64
    top2 = np.sort(logits, axis=1)[:, -2:]
    near_tie = (top2[:, 1] - top2[:, 0]) <= 1e-5
    assert near_tie.mean() < 0.01
    assert np.array_equal(got[~near_tie], ref[~near_tie])
    # the printed accuracy line is the reference's form
    assert "all-node accuracy" in capsys.readouterr().out


@pytest.mark.parametrize("name", ["cora", "citeseer", "pubmed", "synthetic"])
def test_pipeline_dataset_is_the_reference(name):
    same_dataset(tcli._load_dataset(name, "cpu"), jcli._load_dataset(name),
                 name)


def test_nodepred_graph_is_the_reference():
    tg = dt.add_self_loop(dt.remove_self_loop(
        tcli._load_dataset("cora", "cpu")[0]))
    jg = dgl_tpu.add_self_loop(dgl_tpu.remove_self_loop(
        jcli._load_dataset("cora")[0]))
    same_graph(tg, jg, "nodepred cora")


def test_graphpred_and_linkpred_datasets_are_the_reference():
    tds = dt.data.GraphClassificationDataset(num_graphs=96, device="cpu")
    jds = dgl_tpu.data.GraphClassificationDataset(num_graphs=96)
    same_dataset(tds, jds, "graphpred")
    kw = dict(num_nodes=2000, num_edges=16000, num_classes=4, feat_dim=32)
    same_item(dt.data.SyntheticDataset(**kw, device="cpu")[0],
              dgl_tpu.data.SyntheticDataset(**kw)[0], "linkpred")


def test_nodepred_gcn_cora_trains_on_the_cpu(capsys):
    cfg = dict(tcli.RECIPES["nodepred_gcn_cora"], epochs=60)
    acc = tcli.train(cfg, device="cpu")
    assert acc >= 0.6
    assert "test accuracy" in capsys.readouterr().out


@pytest.mark.parametrize("model", ["gat", "sage"])
def test_nodepred_models_train(model, capsys):
    acc = tcli.train({"pipeline": "nodepred", "model": model,
                      "dataset": "cora", "epochs": 3}, device="cpu")
    assert 0.0 <= acc <= 1.0
    assert "epoch    0 loss" in capsys.readouterr().out


@pytest.mark.parametrize("pipeline, epochs", [("nodepred-ns", 2),
                                              ("graphpred", 20),
                                              ("linkpred", 10)])
def test_other_pipelines_train(pipeline, epochs, capsys):
    cfg = dict(next(r for r in tcli.RECIPES.values()
                    if r["pipeline"] == pipeline), epochs=epochs)
    losses = tcli.train(cfg, device="cpu")
    assert len(losses) == epochs
    assert np.all(np.isfinite(losses))
    assert losses[-1] < losses[0]


def test_train_and_apply_need_cuda_unless_asked_for_the_cpu(monkeypatch,
                                                            tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["train", "--epochs", "1"],
                 ["apply", "--checkpoint", str(tmp_path / "none.npz")]):
        with pytest.raises(SystemExit) as info:
            tcli.main(argv)
        assert "CUDA" in str(info.value), info.value
    with pytest.raises(tcli.NoCUDA, match="CUDA"):
        tcli.train({"pipeline": "linkpred"})


def test_unknown_names_exit():
    with pytest.raises(SystemExit):
        tcli._load_dataset("nope", "cpu")
    with pytest.raises(SystemExit):
        tcli._build_model("nope", 4, 4, 2, device="cpu")
    with pytest.raises(SystemExit):
        tcli.train({"pipeline": "nope"}, device="cpu")
