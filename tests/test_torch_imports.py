"""Guards of the PyTorch port's boundaries.

- No module of ``dgl_tpu_torch/``, and not ``chip_smoke.py``, imports JAX,
  flax, optax or anything of the JAX package (read with ``ast``, so
  imports inside functions count too).
- The entry points place their tensors on CUDA unless the caller asks for
  the CPU: in a process that sees no card, calling them without
  ``device`` raises instead of running on the CPU.
- No module of ``dgl_tpu_torch/data/`` imports networkx, yaml, pyarrow
  or ogb at module level (the card's host has none of them), and MiniGC
  and the karate club build where ``import networkx`` fails, equal to the
  reference's.
"""
import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "dgl_tpu")


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _dirs, names in os.walk(os.path.join(ROOT, "dgl_tpu_torch")):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _imported_roots(path):
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""


def test_port_imports_no_jax_and_nothing_of_dgl_tpu():
    files = _port_files()
    assert len(files) > 10, files  # the walk found the package
    bad = []
    for path in files:
        for lineno, name in _imported_roots(path):
            if name.split(".")[0] in FORBIDDEN:
                bad.append(f"{os.path.relpath(path, ROOT)}:{lineno}: {name}")
    assert not bad, "forbidden imports:\n" + "\n".join(bad)


def test_guard_catches_a_forbidden_import(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("def f():\n    from dgl_tpu.ops import spmm\n"
                 "import jax.numpy as jnp\nimport dgl_tpu_torch\n")
    names = [n for _l, n in _imported_roots(str(p))]
    assert sorted(n for n in names if n.split(".")[0] in FORBIDDEN) == [
        "dgl_tpu.ops", "jax.numpy"]


_CALLS = {
    "graph": "dt.graph((np.array([0, 1]), np.array([1, 2])), num_nodes=3{})",
    "GraphSAGE": "dt.models.GraphSAGE(4, 8, 2, num_layers=2{})",
    "GCN": "dt.models.GCN(4, 8, 2{})",
    "GAT": "dt.models.GAT(4, 8, 2, heads=2{})",
    "SAGEConv": "dt.nn.SAGEConv(4, 8{})",
    "GraphConv": "dt.nn.GraphConv(4, 8{})",
    "GATConv": "dt.nn.GATConv(4, 8, 2{})",
    "Relation.from_coo": "dt.Relation.from_coo(np.array([0]), np.array([1]), "
                         "2, 2{})",
    "create_block": "dt.create_block((np.array([0, 1]), np.array([0, 0])), "
                    "2, 1{})",
    "FixedShapeNeighborSampler": (
        "dt.dataloading.FixedShapeNeighborSampler([2], 4{}).sample_blocks("
        "dt.graph((np.array([0, 1]), np.array([1, 2])), num_nodes=3, "
        "device='cpu'), np.array([1, 2]))"),
    "device_seed_batches": "dt.sampling.device_seed_batches("
                           "torch.Generator(), 10, 4{})",
    "DeviceSAGE": "dt.models.DeviceSAGE(4, 8, 2{})",
    "PNAConv": "dt.nn.PNAConv(4, 8{})",
    "DGNConv": "dt.nn.DGNConv(4, 8{})",
    "GatedGCNConv": "dt.nn.GatedGCNConv(4, 3, 8{})",
    "TWIRLSConv": "dt.nn.TWIRLSConv(4, 8, 6, 2{})",
    "EGNNConv": "dt.nn.EGNNConv(4, 6, 8{})",
    "DenseGraphConv": "dt.nn.DenseGraphConv(4, 8{})",
    "DenseSAGEConv": "dt.nn.DenseSAGEConv(4, 8{})",
    "DenseChebConv": "dt.nn.DenseChebConv(4, 8, 2{})",
    "WeightBasis": "dt.nn.WeightBasis((4, 8), 2, 3{})",
    "EdgePredictor": "dt.nn.EdgePredictor('cat', 4, 2{})",
    "TransE": "dt.nn.TransE(3, 4{})",
    "TransR": "dt.nn.TransR(3, 4, 5{})",
    "NodeEmbedding": "dt.nn.NodeEmbedding(10, 4{})",
    "BiasedMHA": "dt.nn.BiasedMHA(8, 2{})",
    "GraphormerLayer": "dt.nn.GraphormerLayer(8, 16, 2{})",
    "EGTLayer": "dt.nn.EGTLayer(8, 4, 2{})",
    "DegreeEncoder": "dt.nn.DegreeEncoder(5, 8{})",
    "LapPosEncoder": "dt.nn.LapPosEncoder('Transformer', 1, 3, 8{})",
    "PathEncoder": "dt.nn.PathEncoder(3, 4{})",
    "SpatialEncoder": "dt.nn.SpatialEncoder(4{})",
    "SpatialEncoder3d": "dt.nn.SpatialEncoder3d(4{})",
    "MLP": "dt.nn.MLP(4, (8, 2){})",
    "sparse.from_coo": "dt.sparse.from_coo(np.array([0, 1]), "
                       "np.array([1, 2]){})",
    "sparse.from_csr": "dt.sparse.from_csr(np.array([0, 1, 2]), "
                       "np.array([1, 0]){})",
    "sparse.from_csc": "dt.sparse.from_csc(np.array([0, 1, 2]), "
                       "np.array([1, 0]){})",
    "sparse.diag": "dt.sparse.diag(np.ones(3, np.float32){})",
    "sparse.identity": "dt.sparse.identity((3, 4){})",
    "sparse.from_scipy": "dt.sparse.from_scipy(__import__('scipy.sparse')"
                         ".sparse.eye(3, format='csr'){})",
    "from_scipy": "dt.from_scipy(__import__('scipy.sparse').sparse.eye(3)"
                  "{})",
    "bipartite_from_scipy": "dt.bipartite_from_scipy(__import__("
                            "'scipy.sparse').sparse.eye(3), 'u', 'e', 'v'"
                            "{})",
    "rand_graph": "dt.rand_graph(5, 8, seed=0{})",
    "rand_bipartite": "dt.rand_bipartite('u', 'e', 'v', 4, 5, 8, seed=0{})",
    "from_networkx": "dt.from_networkx(__import__('networkx').path_graph(3)"
                     "{})",
    "bipartite_from_networkx": "dt.bipartite_from_networkx(__import__("
                               "'networkx').complete_bipartite_graph(2, 3),"
                               " 'u', 'e', 'v'{})",
    "knn_graph": "dt.knn_graph(np.eye(5, 3, dtype=np.float32), 2{})",
    "segmented_knn_graph": "dt.segmented_knn_graph(np.eye(5, 3), 2, [2, 3]"
                           "{})",
    "radius_graph": "dt.radius_graph(np.eye(5, 3), 0.5{})",
    "knn": "dt.knn(2, np.eye(5, 3), [5]{})",
    "pairwise_squared_distance": "dt.pairwise_squared_distance("
                                 "np.eye(5, 3){})",
    "farthest_point_sampler": "dt.geometry.farthest_point_sampler("
                              "np.eye(5, 3)[None], 2{})",
    "KNNGraph": "dt.nn.KNNGraph(2)(np.eye(5, 3){})",
    "SegmentedKNNGraph": "dt.nn.SegmentedKNNGraph(2)(np.eye(5, 3), [2, 3]"
                         "{})",
    "RadiusGraph": "dt.nn.RadiusGraph(0.5)(np.eye(5, 3){})",
    "Set2Set": "dt.nn.Set2Set(4, 2{})",
    "WeightAndSum": "dt.nn.WeightAndSum(4{})",
    "MultiHeadAttention": "dt.nn.MultiHeadAttention(4, 2, 3, 8{})",
    "SetAttentionBlock": "dt.nn.SetAttentionBlock(4, 2, 3, 8{})",
    "InducedSetAttentionBlock": "dt.nn.InducedSetAttentionBlock(2, 4, 2, 3,"
                                " 8{})",
    "PMALayer": "dt.nn.PMALayer(2, 4, 2, 3, 8{})",
    "SetTransformerEncoder": "dt.nn.SetTransformerEncoder(4, 2, 3, 8{})",
    "SetTransformerDecoder": "dt.nn.SetTransformerDecoder(4, 2, 3, 8, 1, 2"
                             "{})",
    "GIN": "dt.models.GIN(4, 8, 2{})",
    "Graphormer": "dt.models.Graphormer(4, 8, 2, num_heads=2{})",
    "DataLoader": "list(dt.dataloading.DataLoader(dt.graph((np.array([0, 1]),"
                  " np.array([1, 2])), num_nodes=3, device='cpu'), "
                  "np.array([1, 2]), dt.dataloading.NeighborSampler([1]), "
                  "use_prefetch_thread=False{}))",
    "DataLoader prefetch thread": (
        "list(dt.dataloading.DataLoader(dt.graph((np.array([0, 1]), "
        "np.array([1, 2])), num_nodes=3, device='cpu'), np.array([1, 2]), "
        "dt.dataloading.NeighborSampler([1]){}))"),
    "GraphDataLoader": "list(dt.dataloading.GraphDataLoader([dt.graph(("
                       "np.array([0]), np.array([1])), num_nodes=2, "
                       "device='cpu')]{}))",
    "GraphCollator": "dt.dataloading.GraphCollator(*[]{}).collate([1, 2])",
    "HeteroFixedShapeNeighborSampler": (
        "(lambda hg: dt.dataloading.HeteroFixedShapeNeighborSampler(hg, "
        "[{{('u', 'e', 'v'): 1}}], 2, seed_ntype='v'{}).sample_blocks(hg, "
        "np.array([0])))(dt.heterograph({{('u', 'e', 'v'): (np.array([0, 1]),"
        " np.array([0, 1]))}}, device='cpu'))"),
    "DeepWalk": "dt.nn.DeepWalk(5, 4{})",
    "MetaPath2Vec": "dt.nn.MetaPath2Vec(5, 4{})",
    "graphbolt.NeighborSamplerStage": (
        "list(dt.graphbolt.NeighborSamplerStage(dt.graphbolt.ItemSampler("
        "dt.graphbolt.ItemSet(np.array([1, 2])), 2), dt.graph((np.array(["
        "0, 1]), np.array([1, 2])), num_nodes=3, device='cpu'), [1], 2{}))"),
    "graphbolt.DeviceNeighborSamplerStage": (
        "dt.graphbolt.DeviceNeighborSamplerStage([], dt.graph((np.array(["
        "0, 1]), np.array([1, 2])), num_nodes=3, device='cpu'), [2]{})"),
    "graphbolt.DeviceFeatureFetcher": "dt.graphbolt.DeviceFeatureFetcher("
                                      "[], {{'x': np.ones((4, 2))}}{})",
    "graphbolt.CopyTo": "dt.graphbolt.CopyTo([]{})._apply("
                        "dt.graphbolt.MiniBatch(seeds=np.arange(2)))",
    "graphbolt.HBMFeatureCache": "dt.graphbolt.HBMFeatureCache("
                                 "dt.graphbolt.NumpyFeature(np.ones((4, 2),"
                                 " np.float32)), np.arange(2){})",
    "graphbolt.gpu_cached_feature": "dt.graphbolt.gpu_cached_feature("
                                    "dt.graphbolt.NumpyFeature(np.ones(("
                                    "4, 2), np.float32)), 16{})",
    "graphbolt.OnDiskDataset": (
        "(lambda d: dt.graphbolt.OnDiskDataset.write(d, name='x', "
        "src=np.array([0]), dst=np.array([1]), num_nodes=2{}).graph)("
        "__import__('tempfile').mkdtemp())"),
    "data.CoraGraphDataset": "dt.data.CoraGraphDataset(raw_dir=__import__("
                             "'tempfile').mkdtemp(){})",
    "data.SyntheticDataset": "dt.data.SyntheticDataset(num_nodes=20, "
                             "num_edges=40{})",
    "data.SyntheticHeteroDataset": "dt.data.SyntheticHeteroDataset(*[]{})",
    "data.MiniGCDataset": "dt.data.MiniGCDataset(8, 4, 6{})",
    "data.KarateClubDataset": "dt.data.KarateClubDataset(*[]{})",
    "data.BAShapeDataset": "dt.data.BAShapeDataset(*[]{})",
    "data.FraudYelpDataset": "dt.data.FraudYelpDataset(num_nodes=50{})",
    "data.QM9Dataset": "dt.data.QM9Dataset(num_graphs=2{})",
    "data.MinesweeperDataset": "dt.data.MinesweeperDataset(*[]{})",
    "data.from_ogb": "dt.data.from_ogb('ogbn-arxiv', root='tests/fixtures/"
                     "ogb'{})",
    "data.generate_mask_tensor": "dt.data.utils.generate_mask_tensor("
                                 "np.ones(3, bool){})",
    "graphbolt.BuiltinDataset": "dt.graphbolt.BuiltinDataset('cora', root="
                                "__import__('tempfile').mkdtemp(){}).graph",
    "parallel.create_mesh": "dt.parallel.create_mesh((2,), ('gp',){})"
                            ".axis_index('gp')",
    "distributed.shard_csc_arrays": "dt.distributed.shard_csc_arrays("
                                    "dt.distributed.PartitionedGraphCSC.build(dt.graph((np.array([0, 1]), np.array([1, 2])), num_nodes=3, device='cpu'), np.array([0, 1, 1]), 2){})",
    "distributed.PartitionedGraphCSC.shard_rows": (
        "dt.distributed.PartitionedGraphCSC.build(dt.graph((np.array([0, 1]), np.array([1, 2])), num_nodes=3, device='cpu'), np.array([0, 1, 1]), 2).shard_rows(np.ones((3, 2)){})"),
    "distributed.DistNeighborSampler": (
        "dt.distributed.DistNeighborSampler(dt.distributed.PartitionedGraphCSC.build(dt.graph((np.array([0, 1]), np.array([1, 2])), num_nodes=3, device='cpu'), np.array([0, 1, 1]), 2), [1], 2{}).sample_blocks("
        "np.array([1]))"),
    "distributed.DistEdgeDataLoader": (
        "list(dt.distributed.DistEdgeDataLoader(dt.distributed.PartitionedGraphCSC.build(dt.graph((np.array([0, 1]), np.array([1, 2])), num_nodes=3, device='cpu'), np.array([0, 1, 1]), 2), np.array([[0, 1]]), "
        "[1], 1{}))"),
    "distributed.DistTensor": "dt.distributed.DistTensor((3, 2){})",
    "distributed.DistEmbedding": "dt.distributed.DistEmbedding(3, 2{})",
    "distributed.merge_graphs": "dt.distributed.merge_graphs([(np.array("
                                "[0]), np.array([1]))], 2{})",
    "graphbolt.MiniBatch.to_dgl_blocks": (
        "dt.graphbolt.MiniBatch(sampled_subgraphs=[dt.graphbolt."
        "SampledSubgraphImpl(dt.graphbolt.CSCFormatBase(np.array([0, 1]), "
        "np.array([1])), np.array([0]), np.array([0, 5]))]).to_dgl_blocks("
        "*[]{})"),
}

_PROBE = """
import json, numpy as np, torch, dgl_tpu_torch as dt
assert not torch.cuda.is_available()
out = {}
for name, call in json.loads(CALLS).items():
    try:
        eval(call.format(""))
        default = None
    except Exception as exc:
        default = f"{type(exc).__name__}: {exc}"
    eval(call.format(', device="cpu"'))
    out[name] = default
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def default_device_errors(tmp_path_factory):
    """Each entry point called without ``device`` and then with
    ``device="cpu"``, in one process that sees no card."""
    import json

    code = f"CALLS = {json.dumps(json.dumps(_CALLS))}\n" + _PROBE
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               DGL_TPU_DOWNLOAD_DIR=str(tmp_path_factory.mktemp("zoo")))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("name", sorted(_CALLS))
def test_entry_point_defaults_to_cuda(name, default_device_errors):
    err = default_device_errors[name]
    assert err is not None, f"{name} ran on the CPU without being asked"
    assert "cuda" in err.lower(), err


# the modules of the graph-utilities slice, each scanned above and
# importable without JAX
SLICE_MODULES = ("transforms.functional", "transforms.module", "traversal",
                 "propagate", "geometry", "geometry.fps",
                 "geometry.edge_coarsening", "nn.factory", "nn.glob",
                 "models.gin", "models.graphormer")


# the modules of the samplers-and-dataloading slice
SLICE_MODULES += ("_host", "sampling.neighbor", "sampling.labor",
                  "sampling.negative", "sampling.randomwalks",
                  "sampling.pinsage", "sampling.utils", "dataloading.base",
                  "dataloading.neighbor_sampler",
                  "dataloading.negative_sampler", "dataloading.collators",
                  "dataloading.dataloader", "dataloading.graph_loader",
                  "dataloading.subgraph_samplers", "dataloading.capped",
                  "dataloading.spot_target", "dataloading.worker_utils",
                  "dataloading.hetero_sampler", "nn.network_emb")

# the partitioner-and-explainers slice
SLICE_MODULES += ("distributed", "distributed.dist_context",
                  "distributed.graph_partition_book",
                  "distributed.partition", "data", "data.serialize",
                  "partition_mod", "nn.explain", "nn.explain.gnnexplainer",
                  "nn.explain.hetero_gnnexplainer",
                  "nn.explain.pgexplainer", "nn.explain.hetero_pgexplainer",
                  "nn.explain.subgraphx", "nn.explain.hetero_subgraphx")

# the GraphBolt slice
SLICE_MODULES += ("graphbolt", "graphbolt.base", "graphbolt.dataloader",
                  "graphbolt.datapipe_utils", "graphbolt.dataset",
                  "graphbolt.feature_store", "graphbolt.internal_utils",
                  "graphbolt.item_sampler", "graphbolt.itemset",
                  "graphbolt.lazy", "graphbolt.minibatch",
                  "graphbolt.neighbor_sampler_gb", "graphbolt.ondisk_dataset",
                  "graphbolt.sampling_graph", "graphbolt.subgraph_sampler",
                  "graphbolt.impl.cache_policy",
                  "graphbolt.impl.feature_stores",
                  "graphbolt.impl.fused_csc_sampling_graph",
                  "graphbolt.impl.graph_cache", "graphbolt.impl.hbm_cache",
                  "graphbolt.impl.ondisk_metadata")


# the distributed slice
SLICE_MODULES += ("parallel", "parallel.mesh", "parallel.spmd",
                  "distributed.shard", "distributed.dist_spmm",
                  "distributed.hetero_shard", "distributed.cooperative",
                  "distributed.dist_minibatch",
                  "distributed.device_dist_sampler",
                  "distributed.dist_tensor", "distributed.optim",
                  "distributed.dist_graph", "distributed.kvstore",
                  "distributed.server", "distributed.role",
                  "distributed.graph_services")


# the dataset-zoo slice
DATA_MODULES = ("data.dgl_dataset", "data.utils", "data.parsers",
                "data.synthetic", "data.citation", "data.generators",
                "data.heterophilous", "data.csv_dataset", "data.adapter",
                "data.named_extra")
SLICE_MODULES += DATA_MODULES
HOST_ONLY = ("networkx", "yaml", "pyarrow", "ogb")


@pytest.mark.parametrize("name", DATA_MODULES)
def test_data_module_imports_no_host_only_package_at_module_level(name):
    """Module-level imports only: a function may import one lazily (as
    ``from_ogb`` does ``ogb`` and the meta reader ``yaml``)."""
    path = os.path.join(ROOT, "dgl_tpu_torch", *name.split(".")) + ".py"
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=path)
    bad = []
    for node in tree.body:
        names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                 else [node.module or ""] if isinstance(node, ast.ImportFrom)
                 else [])
        bad += [n for n in names if n.split(".")[0] in HOST_ONLY]
    assert not bad, (name, bad)


_WITHOUT_NETWORKX = """
import sys
for name in HOST_ONLY:
    sys.modules[name] = None  # import fails
import numpy as np
import dgl_tpu_torch.data as T
arrays = {}
for i, (g, y) in enumerate(T.MiniGCDataset(96, 4, 41, seed=7,
                                           device="cpu")):
    src, dst = g.edges()
    arrays[f"g{i}"] = np.stack([src.numpy(), dst.numpy()])
    arrays[f"n{i}"] = np.array([g.num_nodes(), int(y)])
k = T.KarateClubDataset(device="cpu")[0]
arrays["karate"] = np.stack([a.numpy() for a in k.edges()])
arrays["karate_label"] = k.ndata["label"].numpy()
np.savez(OUT, **arrays)
"""


def test_minigc_and_karate_build_without_networkx(tmp_path):
    import numpy as np

    import dgl_tpu.data as J

    out = str(tmp_path / "graphs.npz")
    code = (f"HOST_ONLY = {HOST_ONLY!r}\nOUT = {out!r}\n"
            + _WITHOUT_NETWORKX)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    got = np.load(out)
    ref = J.MiniGCDataset(96, 4, 41, seed=7)
    for i, (g, y) in enumerate(ref):
        src, dst = (np.asarray(a) for a in g.edges())
        assert np.array_equal(got[f"g{i}"], np.stack([src, dst])), i
        assert got[f"n{i}"].tolist() == [g.num_nodes(), int(y)], i
    k = J.KarateClubDataset()[0]
    assert np.array_equal(got["karate"],
                          np.stack([np.asarray(a) for a in k.edges()]))
    assert np.array_equal(got["karate_label"], np.asarray(k.ndata["label"]))


@pytest.mark.parametrize("name", SLICE_MODULES)
def test_slice_module_is_scanned_and_exports_its_names(name):
    import importlib

    mod = importlib.import_module(f"dgl_tpu_torch.{name}")
    path = os.path.relpath(mod.__file__, ROOT)
    assert os.path.join(ROOT, path) in _port_files(), path
    for attr in getattr(mod, "__all__", ()):
        assert hasattr(mod, attr), (name, attr)


def test_reorder_orders():
    """``reorder_graph('rcmk')`` runs (scipy's reverse Cuthill-McKee), and
    so does the METIS order over the multilevel partitioner: each a
    permutation of the nodes, the edges kept."""
    import numpy as np

    import dgl_tpu_torch as dt

    g = dt.graph((np.array([0, 1, 2, 3]), np.array([1, 2, 3, 0])),
                 num_nodes=5, device="cpu")
    out = dt.reorder_graph(g, "rcmk")
    assert sorted(out.ndata[dt.NID].tolist()) == list(range(5))
    assert out.num_edges() == 4
    out = dt.reorder_graph(g, "metis", permute_config={"k": 2})
    assert sorted(out.ndata[dt.NID].tolist()) == list(range(5))
    assert out.num_edges() == 4
    assert sorted(dt.metis_perm(g, 2).tolist()) == list(range(5))


def test_cluster_gcn_sampler_needs_the_partitioner():
    """Cluster-GCN's partition is the multilevel partitioner's: the
    sampler's parts cover the nodes once; no port module raises naming
    queue A9, nor A11's partitioner, any more."""
    import numpy as np

    import dgl_tpu_torch as dt

    g = dt.graph((np.array([0, 1, 2, 3]), np.array([1, 2, 3, 0])),
                 num_nodes=4, device="cpu")
    sampler = dt.dataloading.ClusterGCNSampler(g, 2)
    assert sorted(np.concatenate(sampler.part_nodes).tolist()) == [0, 1, 2, 3]
    assert sampler.sample(g, [0, 1]).num_nodes() == 4
    for dirpath, _dirs, names in os.walk(os.path.join(ROOT,
                                                      "dgl_tpu_torch")):
        for n in names:
            if n.endswith(".py"):
                with open(os.path.join(dirpath, n), encoding="utf-8") as f:
                    text = f.read()
                assert "queue A9" not in text, n
                assert "partitioner is ROADMAP" not in text, n
