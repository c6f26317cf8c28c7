"""The port's module transforms (``dgl_tpu_torch.transforms.module``, all 25
classes the reference's ``transforms/__init__.py`` exports) against
``dgl_tpu.transforms.module``.

Each transform runs on both sides on the same numpy-built graphs (the
homogeneous graph with multi-edges, self-loops and frames, its padded copy
and, where the transform takes several types, a graph of two node types
with relations within and across them). The result's arrays, frames and
counts must be equal: exactly for host work and the random transforms
(both draw from ``np.random.default_rng(seed)`` on the host, the masks,
drops, edges and permutations are the same), f32 frames within
rtol = atol = 1e-6 (``GCNNorm``'s and ``SIGNDiffusion``'s device
arithmetic), as ``same_graph`` holds them. A transform the reference
refuses raises on both sides.
"""
import pytest
import torch

import dgl_tpu
from dgl_tpu.base import DGLError as JDGLError
from dgl_tpu.transforms import module as JM
from dgl_tpu_torch.base import DGLError
from dgl_tpu_torch.transforms import module as TM
from test_torch_graph_utils import hetero_pair, same_graph
from test_torch_transforms import self_hetero_pair
from test_torch_transforms_pe import GRAPHS, _same


def _run(pair, make, twice=False):
    """``make(module)(graph)`` on both sides (again on its result with
    ``twice``, which draws the random transforms' generators on): equal
    results, or both raise."""
    jg, tg = pair
    jt, tt = make(JM), make(TM)
    try:
        ref = jt(jg)
        if twice:
            ref = jt(ref)
    except (JDGLError, NotImplementedError, KeyError) as exc:
        with pytest.raises(DGLError if isinstance(exc, JDGLError)
                           else type(exc)):
            got = tt(tg)
            if twice:
                tt(got)
        return None
    got = tt(tg)
    if twice:
        got = tt(got)
    if isinstance(ref, dgl_tpu.Graph):
        same_graph(got, ref)
    else:
        _same(got, ref, 1e-6)
    return got, ref


ANY_GRAPH = {
    "AddSelfLoop": lambda m: m.AddSelfLoop(),
    "AddSelfLoop_duplicate_fill": lambda m: m.AddSelfLoop(
        allow_duplicate=True, edge_feat_names=["w"], fill_data=2.0),
    "RemoveSelfLoop": lambda m: m.RemoveSelfLoop(),
    "ToSimple": lambda m: m.ToSimple(),
    "ToSimple_counts": lambda m: m.ToSimple("cnt"),
    "FeatMask": lambda m: m.FeatMask(0.5, node_feat_names=["x"],
                                     edge_feat_names=["w"], seed=3),
    "RowFeatNormalizer": lambda m: m.RowFeatNormalizer(
        node_feat_names=["x"], edge_feat_names=["w", "absent"]),
    "RowFeatNormalizer_min": lambda m: m.RowFeatNormalizer(
        subtract_min=True, node_feat_names=["x"]),
    "DropNode": lambda m: m.DropNode(0.3, seed=1),
    "DropEdge": lambda m: m.DropEdge(0.4, seed=2),
    "AddEdge": lambda m: m.AddEdge(0.3, seed=4),
    "Compose": lambda m: m.Compose([m.RemoveSelfLoop(), m.AddEdge(0.2, 5),
                                    m.DropEdge(0.2, 6), m.ToSimple()]),
}
HOMO_ONLY = {
    "AddReverse": lambda m: m.AddReverse(),
    "AddReverse_copy": lambda m: m.AddReverse(copy_edata=True),
    "KHopGraph": lambda m: m.KHopGraph(2),
    "GCNNorm": lambda m: m.GCNNorm(),
    "GCNNorm_weighted": lambda m: m.GCNNorm("we"),
    "RandomWalkPE": lambda m: m.RandomWalkPE(4),
    "RandomWalkPE_weighted": lambda m: m.RandomWalkPE(3, "pe",
                                                      eweight_name="we"),
    "LapPE": lambda m: m.LapPE(3),
    "LapPE_eigval_padding": lambda m: m.LapPE(14, "pe", "ev", padding=True),
    "GDC_ppr": lambda m: m.GDC("ppr", alpha=0.2, avg_degree=3),
    "GDC_heat": lambda m: m.GDC("heat", t=2.0, eps=0.01,
                                eweight_name="ww"),
    "GDC_unknown": lambda m: m.GDC("bogus"),
    "SIGNDiffusion": lambda m: m.SIGNDiffusion(2, in_feat_name="x"),
    "SIGNDiffusion_ppr": lambda m: m.SIGNDiffusion(
        3, "x", "sign", diffuse_op="ppr", alpha=0.4),
    "SIGNDiffusion_raw": lambda m: m.SIGNDiffusion(2, "x",
                                                   diffuse_op="raw"),
    "LineGraph": lambda m: m.LineGraph(),
    "LineGraph_no_backtracking": lambda m: m.LineGraph(backtracking=False),
    "PPR": lambda m: m.PPR(alpha=0.25, eweight_name="we", avg_degree=2),
    "HeatKernel": lambda m: m.HeatKernel(t=3.0, eps=0.02),
    "NodeShuffle": lambda m: m.NodeShuffle(seed=5),
    "LaplacianPE": lambda m: m.LaplacianPE(3),
    "LaplacianPE_eigval": lambda m: m.LaplacianPE(12, padding=True,
                                                  eigval_name="ev"),
    "LaplacianPE_eigval_wrong_rows": lambda m: m.LaplacianPE(
        3, eigval_name="ev"),
    "SVDPE": lambda m: m.SVDPE(3),
    "SVDPE_no_flip": lambda m: m.SVDPE(5, "pe", padding=True,
                                       random_flip=False),
    "ToLevi": lambda m: m.ToLevi(),
}
PAIRS = dict(GRAPHS, hetero=self_hetero_pair)
RANDOM = ("FeatMask", "DropNode", "DropEdge", "AddEdge", "Compose",
          "NodeShuffle")


@pytest.mark.parametrize("graph", sorted(PAIRS))
@pytest.mark.parametrize("name", sorted(ANY_GRAPH))
def test_transform_matches(name, graph):
    _run(PAIRS[graph](), ANY_GRAPH[name], twice=name.startswith(RANDOM))


@pytest.mark.parametrize("graph", sorted(GRAPHS))
@pytest.mark.parametrize("name", sorted(HOMO_ONLY))
def test_homogeneous_transform_matches(name, graph):
    _run(GRAPHS[graph](), HOMO_ONLY[name], twice=name.startswith(RANDOM))


@pytest.mark.parametrize("keep", [True, False])
def test_add_metapaths(keep):
    """(On a graph without node frames: the reference's
    ``metapath_reachable_graph`` raises on a same-type path over node
    frames, see ``test_torch_transforms_pe.test_metapath_reachable_graph``;
    ``AddMetaPaths`` carries no frames.)"""
    paths = {"co_buy": ["buys", "bought_by"],
             "tagged": ["bought_by", "buys", "has"]}
    _run(hetero_pair(frames=False),
         lambda m: m.AddMetaPaths(paths, keep_orig_edges=keep))


def test_gcn_norm_padded_edges_take_the_last_nodes_factors():
    """The padded edges' weights are the reference's: their own weight
    times the last node's out- and in-degree factors."""
    jg, tg = GRAPHS["padded"]()
    out = TM.GCNNorm("we")(tg)
    ref = JM.GCNNorm("we")(jg)
    assert out is tg
    rel = tg._relation()
    w = out.edata["we"]
    assert w.shape[0] == rel.num_edges_padded > rel.num_edges
    _same(w, ref.edata["we"], 1e-6)
    assert torch.all(w[rel.num_edges:] != 0)


def test_transforms_write_into_their_input_and_repr():
    jg, tg = GRAPHS["homo"]()
    for t in (TM.RandomWalkPE(2), TM.GCNNorm(), TM.SVDPE(2),
              TM.SIGNDiffusion(1, "x"), TM.FeatMask(node_feat_names=["x"])):
        assert t(tg) is tg
    assert repr(TM.ToLevi()) == repr(JM.ToLevi()) == "ToLevi()"
    for base in (JM.BaseTransform(), TM.BaseTransform()):
        with pytest.raises(NotImplementedError):
            base(jg)
