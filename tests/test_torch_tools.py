"""The port's data tools (``dgl_tpu_torch/tools/``) against the JAX
package's (``tools/``), each run on the same input files in ``tmp_path``
(the JAX tools through ``runpy`` as ``__main__``, the port's through
``main(argv)`` with ``--device cpu``).

- ``partition_cli``: the same book, assignment and parts; each package
  loads the parts the other wrote.
- ``dispatch_partitions``: the parts' feature files equal array for
  array; each package's ``verify`` passes on the other's directory.
- ``chunked_dispatch``: ``write_chunked``'s files byte for byte (the
  metadata's paths name each side's directory; an integer frame's chunks
  hold int64 in the port where the reference, JAX without x64, has
  int32: equal values), ``dispatch``'s book and
  assignment equal and its parts loaded across; its parts of a random
  assignment hold ``partition_graph``'s nodes and ids, and the owned
  nodes' features and in-edges, for that assignment.
- ``ogb_to_ondisk``: ``--graph`` writes the same files byte for byte (the
  labels as above) and
  each package's ``OnDiskDataset`` loads the other's; ``--ogb`` raises as
  the reference does without the ``ogb`` package, and reads OGB's raw
  layout under ``--root`` (the checkout's fixture).
- every tool stops with an error naming CUDA without a card.

The reference's native library is loaded first: without it its
partitioner matches nodes in numpy and the parts differ.
"""
import filecmp
import json
import os
import runpy
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dgl_tpu
from dgl_tpu.distributed import partition as JP
from dgl_tpu.base import DGLError as JDGLError
from dgl_tpu.graphbolt import OnDiskDataset as JOnDisk
import dgl_tpu_torch as dt
import dgl_tpu_torch.distributed as td
from dgl_tpu_torch.data import serialize as tser
from dgl_tpu_torch.graphbolt import OnDiskDataset as TOnDisk
from dgl_tpu_torch.tools import (chunked_dispatch, dispatch_partitions,
                                 ogb_to_ondisk, partition_cli)

from test_torch_data import same_array
from test_torch_graph_utils import same_graph
from test_torch_partition import sbm_edges
from test_torch_sampling import reference_native

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = ["--device", "cpu"]
N, E, PARTS = 600, 4000, 4


@pytest.fixture(autouse=True, scope="module")
def _reference_native():
    reference_native()


def run_reference(monkeypatch, tool, *argv):
    """``tools/<tool>.py`` as a program with ``argv``."""
    monkeypatch.setattr(sys, "argv", [tool] + [str(a) for a in argv])
    runpy.run_path(os.path.join(ROOT, "tools", f"{tool}.py"),
                   run_name="__main__")


def graph_pair():
    """An SBM graph with features, labels and masks, in both packages."""
    src, dst = sbm_edges(N, E, 5)
    rng = np.random.default_rng(6)
    frames = {"feat": rng.normal(size=(N, 8)).astype(np.float32),
              "label": rng.integers(0, 4, N),
              "train_mask": rng.random(N) < 0.5,
              "val_mask": rng.random(N) < 0.2,
              "test_mask": rng.random(N) < 0.3}
    jg = dgl_tpu.graph((src, dst), num_nodes=N)
    tg = dt.graph((src, dst), num_nodes=N, device="cpu")
    for k, v in frames.items():
        jg.ndata[k] = jnp.asarray(v)
        tg.ndata[k] = torch.from_numpy(v)
    return jg, tg, frames


@pytest.fixture
def saved(tmp_path):
    """The graph saved by the port's ``save_graphs``, and its features."""
    _, tg, frames = graph_pair()
    path = str(tmp_path / "g.npz")
    tser.save_graphs(path, [tg])
    feats = str(tmp_path / "feats.npz")
    np.savez(feats, feat=frames["feat"], label=frames["label"])
    return path, feats, tg


def same_parts(tdir, jdir, k, what):
    """Each part as both packages load it, from both directories."""
    for p in range(k):
        t_own, _ = td.load_partition(tdir, p, device="cpu")
        j_own, _ = JP.load_partition(jdir, p)
        same_graph(t_own, j_own, f"{what}: part {p}", batch=False)
        t_other, _ = td.load_partition(jdir, p, device="cpu")
        same_graph(t_other, j_own, f"{what}: the reference's part {p} in "
                   "the port", batch=False)
        j_other, _ = JP.load_partition(tdir, p)
        same_graph(t_own, j_other, f"{what}: the port's part {p} in the "
                   "reference", batch=False)


def same_file(got, ref):
    """Byte for byte, but for an ``.npy`` of integers that the port keeps
    as int64 where the reference (JAX without x64) has int32: then equal
    values."""
    if filecmp.cmp(got, ref, shallow=False):
        return
    assert got.endswith(".npy"), got
    a, b = np.load(got), np.load(ref)
    assert (a.dtype, b.dtype) == (np.int64, np.int32), (got, a.dtype, b.dtype)
    same_array(a, b, got)


def book(d, name):
    with open(os.path.join(d, f"{name}.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("method", ["metis", "random"])
def test_partition_cli_and_dispatch(saved, tmp_path, monkeypatch, capsys,
                                    method):
    path, feats, _ = saved
    tdir, jdir = str(tmp_path / "t"), str(tmp_path / "j")
    partition_cli.main(["--graph", path, "--num-parts", str(PARTS), "--out",
                        tdir, "--method", method] + CPU)
    run_reference(monkeypatch, "partition_cli", "--graph", path,
                  "--num-parts", PARTS, "--out", jdir, "--method", method)
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == lines[2] == f"graph: {N} nodes, {E} edges"
    assert book(tdir, "graph") == book(jdir, "graph")
    same_array(td.load_assignment(tdir), JP.load_assignment(jdir),
               "assignment")
    same_parts(tdir, jdir, PARTS, f"partition_cli {method}")

    dispatch_partitions.main(["dispatch", "--parts", tdir, "--node-feats",
                              feats])
    run_reference(monkeypatch, "dispatch_partitions", "dispatch", "--parts",
                  jdir, "--node-feats", feats)
    for p in range(PARTS):
        got = np.load(os.path.join(tdir, f"part{p}_feats.npz"))
        ref = np.load(os.path.join(jdir, f"part{p}_feats.npz"))
        assert sorted(got.files) == sorted(ref.files)
        for k in ref.files:
            same_array(got[k], ref[k], f"part {p} {k}")
    capsys.readouterr()
    # each package verifies the other's directory
    assert dispatch_partitions.main(["verify", "--parts", jdir] + CPU) == \
        PARTS
    run_reference(monkeypatch, "dispatch_partitions", "verify", "--parts",
                  tdir)
    out = capsys.readouterr().out
    assert out.count(f"verified {PARTS} parts, {N} nodes: OK") == 2


def test_verify_reports_a_bad_feature_file(saved, tmp_path):
    path, feats, _ = saved
    d = str(tmp_path / "t")
    partition_cli.main(["--graph", path, "--num-parts", "2", "--out", d]
                       + CPU)
    np.savez(os.path.join(d, "part0_feats.npz"), _global_ids=np.arange(3))
    with pytest.raises(SystemExit) as info:
        dispatch_partitions.main(["verify", "--parts", d] + CPU)
    assert info.value.code == 1


def test_chunked_dispatch(tmp_path, monkeypatch, capsys):
    jg, tg, _ = graph_pair()
    tdir, jdir = str(tmp_path / "tc"), str(tmp_path / "jc")
    ref_mod = runpy.run_path(os.path.join(ROOT, "tools",
                                          "chunked_dispatch.py"),
                             run_name="ref")
    tmeta = chunked_dispatch.write_chunked(tg, "sbm", tdir)
    jmeta = ref_mod["write_chunked"](jg, "sbm", jdir)
    names = sorted(os.listdir(jdir))
    assert sorted(os.listdir(tdir)) == names
    for f in names:
        if f != "metadata.json":
            same_file(os.path.join(tdir, f), os.path.join(jdir, f))
    with open(tmeta) as a, open(jmeta) as b:
        assert json.load(a) == json.loads(b.read().replace(jdir, tdir))

    assign = np.random.default_rng(7).integers(0, PARTS, N)
    apath = str(tmp_path / "assign.npy")
    np.save(apath, assign)
    tout, jout = str(tmp_path / "ts"), str(tmp_path / "js")
    got = chunked_dispatch.main(["--meta", tmeta, "--assignment", apath,
                                 "--num-parts", str(PARTS), "--out", tout]
                                + CPU)
    run_reference(monkeypatch, "chunked_dispatch", "--meta", jmeta,
                  "--assignment", apath, "--num-parts", PARTS, "--out", jout)
    printed = capsys.readouterr().out.splitlines()
    assert json.loads(printed[0]) == json.loads(printed[1]) == got
    assert book(tout, "sbm") == book(jout, "sbm")
    assert filecmp.cmp(os.path.join(tout, "assignment.npy"),
                       os.path.join(jout, "assignment.npy"), shallow=False)
    same_parts(tout, jout, PARTS, "chunked_dispatch")
    # partition_graph's parts for the same assignment: the same nodes
    # (owned, then the halo), ids, features and in-edges of the owned
    # nodes (its parts also hold the edges among the halo's nodes)
    pdir = str(tmp_path / "pg")
    td.partition_graph(tg, "sbm", PARTS, pdir, parts=assign)
    for p in range(PARTS):
        a, _ = td.load_partition(tout, p, device="cpu")
        b, _ = td.load_partition(pdir, p, device="cpu")
        same_owned_view(a, b, f"chunked part {p} vs partition_graph's")


def owned_view(g):
    """A part's node ids (``_new_id``) and inner flags in the order of the
    ids, its owned nodes' features in that order (the chunked parts leave
    the halo's rows zero), and the owned nodes' in-edges as sorted (src,
    dst) pairs of new ids (the local order differs: ``partition_graph``'s
    follows the old ids)."""
    nid = g.ndata["_new_id"].numpy()
    inner = g.ndata["inner_node"].numpy().astype(bool)
    src, dst = (t.numpy() for t in g.edges())
    keep = inner[dst]
    pairs = np.stack([nid[src[keep]], nid[dst[keep]]], 1)
    pairs = pairs[np.lexsort((pairs[:, 1], pairs[:, 0]))]
    order = np.argsort(nid)
    owned = order[inner[order]]
    return nid[order], inner[order], pairs, {
        k: g.ndata[k].numpy()[owned] for k in g.ndata
        if not k.startswith("_") and k != "inner_node"}


def same_owned_view(a, b, what):
    for x, y, part in zip(owned_view(a), owned_view(b),
                          ("ids", "inner", "in-edges", "frames")):
        if isinstance(y, dict):
            assert set(x) == set(y), (what, set(x), set(y))
            for k in y:
                same_array(x[k], y[k], f"{what}: {k}")
        else:
            same_array(x, y, f"{what}: {part}")


def test_ogb_to_ondisk_graph(saved, tmp_path, monkeypatch, capsys):
    path, _, tg = saved
    tdir, jdir = str(tmp_path / "t"), str(tmp_path / "j")
    ogb_to_ondisk.main(["--graph", path, "--out", tdir] + CPU)
    run_reference(monkeypatch, "ogb_to_ondisk", "--graph", path, "--out",
                  jdir)
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].replace(tdir, jdir) == lines[1]
    names = sorted(os.listdir(jdir))
    assert sorted(os.listdir(tdir)) == names
    for f in names:
        same_file(os.path.join(tdir, f), os.path.join(jdir, f))
    # each package loads the other's directory
    for t_ds, j_ds in ((TOnDisk(jdir, device="cpu"), JOnDisk(jdir)),
                       (TOnDisk(tdir, device="cpu"), JOnDisk(tdir))):
        assert t_ds.graph.num_nodes() == j_ds.graph.num_nodes() == N
        for a, b in zip(t_ds.graph.edges(), j_ds.graph.edges()):
            same_array(a, b, "edges")
        ids = np.arange(N)
        same_array(t_ds.feature.read("node", "_N", "feat", ids),
                   j_ds.feature.read("node", "_N", "feat", ids), "feat")


def test_ogb_to_ondisk_ogb(tmp_path, monkeypatch):
    try:
        import ogb  # noqa: F401
        pytest.skip("the ogb package is installed: --ogb would download")
    except ImportError:
        pass
    with pytest.raises(dt.DGLError, match="ogb"):
        ogb_to_ondisk.main(["--ogb", "ogbn-arxiv", "--out",
                            str(tmp_path / "t")] + CPU)
    with pytest.raises(JDGLError, match="ogb"):
        run_reference(monkeypatch, "ogb_to_ondisk", "--ogb", "ogbn-arxiv",
                      "--out", str(tmp_path / "j"))
    root = os.path.join(ROOT, "tests", "fixtures", "ogb")
    out = str(tmp_path / "fixture")
    ds = ogb_to_ondisk.main(["--ogb", "ogbn-arxiv_mid", "--root", root,
                             "--out", out] + CPU)
    g = dt.data.from_ogb("ogbn-arxiv_mid", root=root, device="cpu")
    jds = JOnDisk(out)
    for a, b, c in zip(ds.graph.edges(), g.edges(), jds.graph.edges()):
        same_array(a, b, "edges")
        same_array(a, c, "edges in the reference")
    ids = np.arange(g.num_nodes())
    same_array(ds.feature.read("node", "_N", "feat", ids), g.ndata["feat"],
               "features")


TOOLS = {"partition_cli": ["--graph", "g.npz", "--num-parts", "2", "--out",
                           "o"],
         "dispatch_partitions": ["verify", "--parts", "p"],
         "chunked_dispatch": ["--meta", "m.json", "--assignment", "a.npy",
                              "--num-parts", "2", "--out", "o"],
         "ogb_to_ondisk": ["--graph", "g.npz", "--out", "o"]}


def test_every_tool_but_the_launcher_has_a_counterpart():
    tools = sorted(f[:-3] for f in os.listdir(os.path.join(ROOT, "tools"))
                   if f.endswith(".py"))
    assert tools == sorted(list(TOOLS) + ["launch"])
    ported = sorted(f[:-3] for f in os.listdir(os.path.join(
        ROOT, "dgl_tpu_torch", "tools")) if f.endswith(".py")
        and not f.startswith("_"))
    assert ported == sorted(TOOLS)


@pytest.mark.parametrize("tool", sorted(TOOLS))
def test_tools_need_cuda_unless_asked_for_the_cpu(tool, monkeypatch):
    import importlib

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = importlib.import_module(f"dgl_tpu_torch.tools.{tool}")
    with pytest.raises(SystemExit) as info:
        mod.main(TOOLS[tool])
    assert "CUDA" in str(info.value), info.value
