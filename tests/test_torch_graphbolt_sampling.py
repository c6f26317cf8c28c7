"""The port's GraphBolt sampling against ``dgl_tpu.graphbolt``:
``FusedCSCSamplingGraph`` and its picks, the sampler stages, the
compactions, the graph cache, the PyG and DGL block views, the shared
memory pair, the on-device backend, and a GraphSAGE step over
``NeighborSamplerStage`` blocks.

Both sides draw from the same numpy generators (``FusedCSCSamplingGraph``
picks, the item shuffles, the negatives) or pick in ``csrc/host_ops.cpp``
(the fixed-shape blocks), so picks, edge ids, blocks, compacted CSCs and
item batches are held exactly. The GraphSAGE step over the blocks is held
at rtol = 1e-4, atol = 1e-5 * max|ref| (the minibatch bound: the same f32
operations summed in another order), with the reference's weights carried
over by ``dt.from_flax_params``. The device backend's draws come from a
``torch.Generator``, not the reference's JAX key, so it is held by what
must be true of any draw: every pick is an in-edge, the frontiers are well
formed and the features are the table's rows; its loss falls.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

import dgl_tpu
from dgl_tpu import graphbolt as jgb
from dgl_tpu.models import GraphSAGE as JGraphSAGE
import dgl_tpu_torch as dt
from dgl_tpu_torch import function as fn
from dgl_tpu_torch import graphbolt as tgb
from dgl_tpu_torch.base import EID, NID
from dgl_tpu_torch.models import DeviceSAGE, GraphSAGE

from test_torch_graph_utils import np_of, same_graph
from test_torch_graphbolt import exact, graph_arrays
from test_torch_sampling import reference_native


@pytest.fixture(autouse=True, scope="module")
def _reference_native():
    reference_native()


@pytest.fixture(scope="module")
def graphs():
    src, dst = graph_arrays()
    return (dgl_tpu.graph((src, dst), num_nodes=100),
            dt.graph((src, dst), num_nodes=100, device="cpu"))


def _small(n=50, e=400, seed=0):
    src, dst = graph_arrays(n, e, seed)
    return (dgl_tpu.graph((src, dst), num_nodes=n),
            dt.graph((src, dst), num_nodes=n, device="cpu"), src, dst)


def sub_arrays(sub):
    """A SampledSubgraphImpl's arrays, None where absent."""
    return [sub.sampled_csc.indptr, sub.sampled_csc.indices,
            sub.original_column_node_ids, sub.original_row_node_ids,
            sub.original_edge_ids, sub.type_per_edge]


def same_sub(got, ref):
    assert isinstance(got, tgb.SampledSubgraphImpl)
    exact(sub_arrays(got), sub_arrays(ref))
    assert got.num_sampled_edges() == ref.num_sampled_edges()


# ---------------------------------------------------------------------------
# FusedCSCSamplingGraph
# ---------------------------------------------------------------------------


def test_from_dglgraph_roundtrip():
    jg, tg, src, dst = _small()
    got, ref = tgb.from_dglgraph(tg), jgb.from_dglgraph(jg)
    assert isinstance(got, tgb.FusedCSCSamplingGraph)
    assert isinstance(got, tgb.FusedCSCSamplingGraph) and repr(got) == repr(
        ref)
    exact([got.csc_indptr, got.indices, got._eids],
          [ref.csc_indptr, ref.indices, ref._eids])
    assert (got.total_num_nodes, got.total_num_edges, got.num_edges,
            got.num_nodes()) == (50, 400, 400, 50)
    back = got.to_dglgraph(device="cpu")
    assert back.device.type == "cpu"
    exact(back.edges(), ref.to_dglgraph().edges())
    with pytest.raises(dt.DGLError):
        got.num_nodes("user")
    # a padded graph: the padding edges are dropped
    jp = dgl_tpu.graph((np.r_[src, [50, 50]], np.r_[dst, [50, 50]]),
                       num_nodes=50, num_edges=400)
    tp = dt.graph((np.r_[src, [50, 50]], np.r_[dst, [50, 50]]),
                  num_nodes=50, num_edges=400, device="cpu")
    a, b = tgb.from_dglgraph(tp), jgb.from_dglgraph(jp)
    exact([a.csc_indptr, a.indices, a._eids], [b.csc_indptr, b.indices,
                                               b._eids])


@pytest.mark.parametrize("nodes,kw", [
    (np.array([3, 7, 7, 11, 49]), dict(fanouts=[5], seed=0)),
    (np.arange(10), dict(fanouts=[7], replace=True, seed=1)),
    (np.arange(10), dict(fanouts=[-1])),
    (np.arange(0, 50, 3), dict(fanouts=4, seed=5)),
], ids=["no_replace", "replace", "full", "int_fanout"])
def test_sample_neighbors(nodes, kw):
    jg, tg, _, _ = _small()
    same_sub(tgb.from_dglgraph(tg).sample_neighbors(nodes, **kw),
             jgb.from_dglgraph(jg).sample_neighbors(nodes, **kw))


def _weighted(m, probs):
    return m.fused_csc_sampling_graph(
        np.array([0, 0, 0, 0, 2, 3]), np.array([0, 1, 2]),
        edge_attributes={"prob": probs})


@pytest.mark.parametrize("replace", [False, True])
def test_weighted_sampling(replace):
    """``test_weighted_sampling_prefers_heavy_edges``: the same picks seed
    for seed, mostly the heavy edge."""
    probs = np.array([50.0, 1.0, 1.0], np.float32)
    got, ref = _weighted(tgb, probs), _weighted(jgb, probs)
    picks = []
    for s in range(100):
        a = got.sample_neighbors(np.array([3]), [1], replace, "prob", s)
        b = ref.sample_neighbors(np.array([3]), [1], replace, "prob", s)
        same_sub(a, b)
        picks.append(int(a.sampled_csc.indices[0]))
    assert picks.count(0) / len(picks) > 0.9


def test_prob_cumsum_follows_in_place_writes():
    """The running sum of a tensor's weights is kept while the tensor is
    unchanged and taken again after an in-place write (the reference keys
    it by ``id`` alone and would keep the stale one)."""
    probs = torch.tensor([50.0, 1.0, 1.0])
    g = _weighted(tgb, probs)
    seeds = np.array([3, 3, 3, 3, 3, 3, 3, 3])
    first = g.sample_neighbors(seeds, [1], True, "prob", 0)
    assert len(g._prob_cumsum) == 1
    g.sample_neighbors(seeds, [1], True, "prob", 1)
    assert len(g._prob_cumsum) == 1
    probs[0] = 0.0  # only edge 1 is left into node 3
    after = g.sample_neighbors(seeds, [1], True, "prob", 0)
    assert set(after.sampled_csc.indices.tolist()) == {1}
    assert 0 in first.sampled_csc.indices.tolist()
    # numpy weights have no version: their sum is taken every call
    arr = np.array([50.0, 1.0, 1.0], np.float32)
    h = _weighted(tgb, arr)
    h.sample_neighbors(seeds, [1], True, "prob", 0)
    arr[0] = 0.0
    assert set(h.sample_neighbors(seeds, [1], True, "prob", 0)
               .sampled_csc.indices.tolist()) == {1}


def test_in_subgraph():
    jg, tg, _, dst = _small()
    got = tgb.from_dglgraph(tg).in_subgraph(np.array([5, 6, 49]))
    same_sub(got, jgb.from_dglgraph(jg).in_subgraph(np.array([5, 6, 49])))
    exact(np.diff(got.sampled_csc.indptr),
          np.bincount(dst, minlength=50)[[5, 6, 49]])


@pytest.mark.parametrize("kw", [
    dict(fanouts=[10], node="ts", seed=0, ts=[4]),
    dict(fanouts=[-1], edge="ets", seed=0, ts=[2]),
    dict(fanouts=[4], replace=True, node="ts", seed=0, ts=[1]),
    dict(fanouts=[3], node="ts", edge="ets", seed=3, ts=[6]),
], ids=["node_ts", "edge_ts", "replace", "both"])
def test_temporal_sample_neighbors(kw):
    src, dst = np.arange(10), np.full(10, 10)
    out = []
    for m, g in ((tgb, dt.graph((src, dst), num_nodes=11, device="cpu")),
                 (jgb, dgl_tpu.graph((src, dst), num_nodes=11))):
        fg = m.from_dglgraph(g)
        fg.node_attributes["ts"] = np.arange(11, dtype=np.int64)
        fg.edge_attributes["ets"] = np.arange(10, dtype=np.int64)
        out.append(fg.temporal_sample_neighbors(
            np.array([10]), np.array(kw["ts"]), kw["fanouts"],
            replace=kw.get("replace", False),
            node_timestamp_attr_name=kw.get("node"),
            edge_timestamp_attr_name=kw.get("edge"), seed=kw["seed"]))
    same_sub(*out)


@pytest.mark.parametrize("fanouts,replace", [([1, 2], False),
                                             ([5, 3], True)])
def test_hetero_fanouts_per_type(fanouts, replace):
    src, dst = np.array([0, 1, 2, 3, 4, 5]), np.array([6] * 6)
    tpe = np.array([0, 0, 0, 1, 1, 1])
    out = []
    for m, g in ((tgb, dt.graph((src, dst), num_nodes=7, device="cpu")),
                 (jgb, dgl_tpu.graph((src, dst), num_nodes=7))):
        fg = m.from_dglgraph(g)
        fg.type_per_edge = tpe
        fg.edge_attributes["p"] = np.array([1, 2, 3, 1, 1, 5], np.float32)
        out.append([fg.sample_neighbors(np.array([6, 6]), fanouts, replace,
                                        seed=0),
                    fg.sample_neighbors(np.array([6]), fanouts, replace, "p",
                                        seed=1)])
    for a, b in zip(*out):
        same_sub(a, b)
    types = tpe[out[0][0].original_edge_ids]
    assert (types == 0).sum() == 2 * fanouts[0]


def test_shared_memory_graph(graphs):
    import uuid

    jg, tg = graphs
    name = f"dgl_tpu_torch_test_{uuid.uuid4().hex[:8]}"
    fused = tgb.from_dglgraph(tg)
    assert fused.copy_to_shared_memory(name) is fused
    try:
        back = tgb.load_from_shared_memory(name)
        exact([back.csc_indptr, back.indices, back._eids],
              [fused.csc_indptr, fused.indices, fused._eids])
        same_sub(back.sample_neighbors(np.arange(5), [3], seed=0),
                 jgb.from_dglgraph(jg).sample_neighbors(np.arange(5), [3],
                                                        seed=0))
    finally:
        fused._shm.close()
        fused._shm.unlink()


def test_abstract_bases():
    for cls in (tgb.SamplingGraph, tgb.SampledSubgraph, tgb.Dataset,
                tgb.Task):
        obj = cls()
        name = [n for n in dir(cls) if not n.startswith("_")][0]
        with pytest.raises(NotImplementedError):
            getattr(obj, name)


# ---------------------------------------------------------------------------
# the sampler stages
# ---------------------------------------------------------------------------


def _seed_batches(m, seeds, batch, **kw):
    return m.ItemSampler(m.ItemSet(seeds, names="seeds"), batch_size=batch,
                         **kw)


def test_neighbor_sampler_stage_input_ids(graphs):
    """``mb.input_nodes`` is ``blocks[0].srcdata[NID]`` on the host
    (padding slots read node 0, not -1), the reference's field."""
    jg, tg = graphs
    got = list(tgb.NeighborSamplerStage(_seed_batches(tgb, np.arange(20), 16),
                                        tg, [2, 3], 16, seed=4,
                                        device="cpu"))
    ref = list(jgb.NeighborSamplerStage(_seed_batches(jgb, np.arange(20), 16),
                                        jg, [2, 3], 16, seed=4))
    for a, b in zip(got, ref):
        assert isinstance(a.input_nodes, np.ndarray)
        assert a.input_nodes.min() >= 0
        exact(a.input_nodes, b.input_nodes)
        exact(a.input_nodes, a.blocks[0].srcdata[NID])
        for tb, jb in zip(a.blocks, b.blocks):
            same_graph(tb, jb, "block", batch=False)
    assert tgb.NeighborSampler is tgb.NeighborSamplerStage
    assert tgb.NeighborSamplerImpl is tgb.NeighborSamplerStage


def test_layer_neighbor_sampler_stage(graphs):
    """``test_layer_neighbor_sampler_stage`` and ``_importance``: the same
    ragged blocks and input ids as the reference's."""
    jg, tg = graphs
    for kw in (dict(seed=0), dict(importance_sampling=-1, seed=1)):
        got = list(tgb.LayerNeighborSampler(
            _seed_batches(tgb, np.arange(40), 40), tg, [5, 5], **kw))
        ref = list(jgb.LayerNeighborSampler(
            _seed_batches(jgb, np.arange(40), 40), jg, [5, 5], **kw))
        (a,), (b,) = got, ref
        exact(a.input_nodes, b.input_nodes)
        assert len(a.blocks) == 2
        for tb, jb in zip(a.blocks, b.blocks):
            same_graph(tb, jb, "LABOR block", batch=False)


def test_uniform_negative_sampler_stage():
    src, dst = graph_arrays(50, 200, 0)
    pairs = np.stack([src[:40], dst[:40]], axis=1)
    out = []
    for m, g in ((tgb, dt.graph((src, dst), num_nodes=50, device="cpu")),
                 (jgb, dgl_tpu.graph((src, dst), num_nodes=50))):
        stage = m.UniformNegativeSampler(_seed_batches(m, pairs, 8), g,
                                         negative_ratio=3, seed=0)
        out.append([[mb.seeds, mb.labels, mb.indexes, mb.negative_srcs,
                     mb.negative_dsts] for mb in stage])
    exact(*out)
    assert len(out[0]) == 5 and out[0][0][0].shape == (32, 2)
    with pytest.raises(ValueError):
        next(iter(tgb.UniformNegativeSampler(
            _seed_batches(tgb, np.arange(4), 2), dt.graph(
                (src, dst), num_nodes=50, device="cpu"))))


def test_minibatch_transformer_and_negative_base():
    def double(mb):
        mb.seeds = np.asarray(mb.seeds) * 2
        return mb

    got = [mb.seeds for mb in tgb.MiniBatchTransformer(
        _seed_batches(tgb, np.arange(20), 5), double)]
    exact(np.concatenate(got), np.arange(20) * 2)
    assert len(tgb.MiniBatchTransformer(_seed_batches(tgb, np.arange(20),
                                                      5))) == 4
    with pytest.raises(ValueError):
        next(iter(tgb.MiniBatchTransformer(
            _seed_batches(tgb, np.arange(20), 5), lambda mb: None)))
    with pytest.raises(NotImplementedError):
        next(iter(tgb.NegativeSampler(_seed_batches(tgb, np.arange(4), 2),
                                      1)))
    with pytest.raises(NotImplementedError):
        next(iter(tgb.SubgraphSampler(_seed_batches(tgb, np.arange(4), 2))))


@pytest.mark.parametrize("reverse", [False, True])
def test_exclude_seed_edges(reverse):
    src, dst = graph_arrays(40, 300, 1)
    pairs = np.stack([src[:16], dst[:16]], axis=1)
    masks = []
    for m, g, kw in ((tgb, dt.graph((src, dst), num_nodes=40, device="cpu"),
                      {"device": "cpu"}),
                     (jgb, dgl_tpu.graph((src, dst), num_nodes=40), {})):
        def to_nodes(mb):
            mb.pair_seeds = np.asarray(mb.seeds)
            mb.seeds = np.unique(mb.pair_seeds.ravel())[:16]
            return mb

        def back(mb):
            mb.seeds = mb.pair_seeds
            return mb

        pipe = m.MiniBatchTransformer(_seed_batches(m, pairs, 16), to_nodes)
        pipe = m.NeighborSamplerStage(pipe, g, [5], 16, seed=0, **kw)
        pipe = m.MiniBatchTransformer(pipe, back)
        if m is tgb:
            pipe = tgb.SeedEdgesExcluder(pipe, include_reverse_edges=reverse)
        else:
            pipe = jgb.MiniBatchTransformer(
                pipe, lambda mb: jgb.exclude_seed_edges(mb, reverse))
        masks.append([mb.blocks[0].edata["_mask"] for mb in pipe])
    exact(*masks)
    assert not masks[0][0].all()
    mb = tgb.MiniBatch(seeds=np.arange(3))
    with pytest.raises(ValueError):
        tgb.exclude_seed_edges(mb)


def test_in_subgraph_sampler_stage(graphs):
    jg, tg = graphs
    out = []
    for m, g in ((tgb, tg), (jgb, jg)):
        stage = m.InSubgraphSampler(_seed_batches(m, np.arange(20), 4), g)
        out.append(list(stage))
    assert len(out[0]) == 5
    for a, b in zip(*out):
        same_sub(a.sampled_subgraphs[0], b.sampled_subgraphs[0])
        exact(a.input_nodes, b.input_nodes)
    fused = tgb.InSubgraphSampler([], tgb.from_dglgraph(tg))
    assert isinstance(fused.graph, tgb.FusedCSCSamplingGraph)


def _per_layer(m, fused, layers, fanout=4, seeds=8, **kw):
    dp = _seed_batches(m, np.arange(seeds), seeds)
    for _ in range(layers):
        dp = m.SamplePerLayer(dp, fused, fanout=fanout, seed=0, **kw)
        dp = m.CompactPerLayer(dp)
    return list(dp)[0]


def test_sample_compact_per_layer(graphs):
    jg, tg = graphs
    got = _per_layer(tgb, tgb.from_dglgraph(tg), 3)
    ref = _per_layer(jgb, jgb.from_dglgraph(jg), 3)
    exact(got.input_nodes, ref.input_nodes)
    assert len(got.sampled_subgraphs) == 3
    for a, b in zip(got.sampled_subgraphs, ref.sampled_subgraphs):
        same_sub(a, b)
    # uncompacted rows are original ids, uniq[compacted] gives them back
    raw = list(tgb.SamplePerLayer(_seed_batches(tgb, np.arange(6), 6),
                                  tgb.from_dglgraph(tg), 4, seed=0))[0]
    comp = list(tgb.CompactPerLayer(tgb.SamplePerLayer(
        _seed_batches(tgb, np.arange(6), 6), tgb.from_dglgraph(tg), 4,
        seed=0)))[0].sampled_subgraphs[0]
    exact(comp.original_row_node_ids[comp.sampled_csc.indices],
          raw.sampled_subgraphs[0].sampled_csc.indices)
    exact(comp.original_row_node_ids[:6], np.arange(6))
    mb = tgb.MiniBatch(seeds=np.arange(2))
    assert tgb.CompactPerLayer([mb])._apply(mb) is mb


def test_temporal_sampler_stages(graphs):
    jg, tg = graphs
    out = []
    for m, g in ((tgb, tg), (jgb, jg)):
        fused = m.from_dglgraph(g)
        fused.node_attributes["ts"] = np.arange(100, dtype=np.int64)

        def attach(mb):
            mb.timestamp = np.asarray(mb.seeds)
            return mb

        res = []
        for cls in (m.TemporalNeighborSampler,
                    m.TemporalLayerNeighborSampler):
            dp = m.MiniBatchTransformer(_seed_batches(m, np.array([50, 80]),
                                                      2), attach)
            kw = {"seed": 0} if cls is m.TemporalNeighborSampler else {}
            dp = cls(dp, fused, fanouts=[5, 3], node_timestamp_attr="ts",
                     **kw)
            res.append(list(dp)[0])
        out.append(res)
    for a, b in zip(*out):
        exact(a.input_nodes, b.input_nodes)
        for x, y in zip(a.sampled_subgraphs, b.sampled_subgraphs):
            same_sub(x, y)
    sub = out[0][0].sampled_subgraphs[-1]
    owners = np.repeat(np.array([50, 80]), np.diff(sub.sampled_csc.indptr))
    assert (sub.sampled_csc.indices <= owners).all()
    assert tgb.TemporalNeighborSamplerImpl is tgb.TemporalNeighborSampler
    with pytest.raises(ValueError):
        list(tgb.TemporalNeighborSampler(
            _seed_batches(tgb, np.arange(2), 2), tgb.from_dglgraph(tg), [2]))


def test_graph_cache_stages(graphs):
    jg, tg = graphs
    results = []
    for m, g in ((tgb, tg), (jgb, jg)):
        fused = m.from_dglgraph(g)
        cache = m.GPUGraphCache(capacity=30)
        epochs = []
        for _ in range(2):
            dp = m.FetchCachedInsubgraphData(
                _seed_batches(m, np.arange(20), 10), fused, cache)
            dp = m.CombineCachedAndFetchedInSubgraph(dp, fused, cache)
            epochs.append(list(dp))
        direct = list(m.FetchInsubgraphData(
            _seed_batches(m, np.arange(20), 10), fused))
        results.append((epochs, direct, cache.hits, cache.misses,
                        cache.hit_rate, sorted(cache._rows)))
    got, ref = results
    assert got[2:] == ref[2:]
    for a, b in zip(got[0][1] + got[1], ref[0][1] + ref[1]):
        same_sub(a.sampled_subgraphs[0], b.sampled_subgraphs[0])
        exact(a.input_nodes, b.input_nodes)
    for a, b in zip(got[0][1], got[1]):
        same_sub(a.sampled_subgraphs[0], b.sampled_subgraphs[0])


def test_multiprocessing_wrapper(graphs):
    _, tg = graphs
    fused = tgb.from_dglgraph(tg)

    def pipe():
        return tgb.SamplePerLayer(_seed_batches(tgb, np.arange(12), 3),
                                  fused, fanout=3, seed=7)

    serial = [mb.sampled_subgraphs[0].sampled_csc.indices for mb in pipe()]
    for workers in (0, 3):
        par = [mb.sampled_subgraphs[0].sampled_csc.indices
               for mb in tgb.MultiprocessingWrapper(pipe(), workers)]
        exact(par, serial)


def test_pyg_layers_and_dgl_blocks(graphs):
    jg, tg = graphs
    got = _per_layer(tgb, tgb.from_dglgraph(tg), 1, seeds=8)
    ref = _per_layer(jgb, jgb.from_dglgraph(jg), 1, seeds=8)
    got.node_features["feat"] = np.ones((3, 2))
    ref.node_features["feat"] = np.ones((3, 2))
    layers = got.to_pyg_layers()
    assert isinstance(layers[0], tgb.PyGLayerData)
    exact([tuple(l) for l in layers], [tuple(l) for l in ref.to_pyg_layers()])
    het = tgb.PyGLayerHeteroData({}, {}, {})
    assert het._fields == jgb.PyGLayerHeteroData._fields
    (tb,), (jb,) = got.to_dgl_blocks(device="cpu"), ref.to_dgl_blocks()
    assert tb.num_dst_nodes() == 8 and tb.device.type == "cpu"
    exact([tb.srcdata[NID], tb.dstdata[NID], tb.edata[EID]],
          [jb.srcdata[NID], jb.dstdata[NID], jb.edata[EID]])
    exact(tb.edges(), jb.edges())
    # aggregation over the block: the per-seed sums of the rows' ids
    x = torch.arange(100, dtype=torch.float32)[:, None]
    tb.srcdata["h"] = x[tb.srcdata[NID]]
    tb.update_all(fn.copy_u("h", "m"), fn.sum("m", "out"))
    sub = got.sampled_subgraphs[0]
    rows = sub.original_row_node_ids[sub.sampled_csc.indices]
    want = np.add.reduceat(rows.astype(np.float32),
                           sub.sampled_csc.indptr[:-1]) * (
        np.diff(sub.sampled_csc.indptr) > 0)
    exact(tb.dstdata["out"][:, 0], want)
    raw = list(tgb.SamplePerLayer(_seed_batches(tgb, np.arange(4), 4),
                                  tgb.from_dglgraph(tg), 2, seed=0))[0]
    with pytest.raises(ValueError, match="COMPACTED"):
        raw.to_dgl_blocks(device="cpu")


# ---------------------------------------------------------------------------
# a GraphSAGE step over NeighborSamplerStage blocks
# ---------------------------------------------------------------------------


def test_graphsage_step_over_stage_blocks(graphs):
    """One step of DGL's GraphBolt recipe (ItemSampler -> NeighborSampler
    -> FeatureFetcher -> CopyTo, GraphSAGE mean, cross-entropy, Adam) on
    both sides: logits, loss, gradients and the parameters after the step
    at rtol = 1e-4, atol = 1e-5 * max|ref|."""
    jg, tg = graphs
    rng = np.random.default_rng(8)
    feats = rng.normal(size=(100, 10)).astype(np.float32)
    labels = rng.integers(0, 4, 100)
    items = (np.arange(60), labels[:60])

    def batch(m, g, **kw):
        dp = m.ItemSampler(m.ItemSet(items, names=("seeds", "labels")),
                           batch_size=16, shuffle=True, seed=0)
        dp = m.NeighborSamplerStage(dp, g, [3, 2], 16, seed=1, **kw)
        dp = m.FeatureFetcher(dp, m.FeatureStore(
            {("node", "_N", "feat"): feats}), ["feat"])
        return next(iter(m.DataLoader(m.CopyTo(dp, **kw))))

    mb, jmb = batch(tgb, tg, device="cpu"), batch(jgb, jg)
    mask = np.zeros(17, np.float32)
    mask[:16] = 1.0
    y = np.zeros(17, np.int64)
    y[:16] = np_of(mb.labels)
    exact(mb.labels, jmb.labels)
    exact(mb.node_features["feat"], jmb.node_features["feat"])

    jm = JGraphSAGE(10, 16, 4, num_layers=2, dropout=0.0)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jmb.blocks,
                              jmb.node_features["feat"])

    def jloss(p):
        logits = jm.apply(p, jmb.blocks, jmb.node_features["feat"])
        ce = optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(y, jnp.int32))
        return (ce * mask).sum() / mask.sum(), logits

    tx = optax.adam(1e-3)

    @jax.jit
    def jstep(p):
        (l, out), g = jax.value_and_grad(jloss, has_aux=True)(p)
        upd, _ = tx.update(g, tx.init(p), p)
        return l, out, g, optax.apply_updates(p, upd)

    jl, jlogits, jgrads, jnew = jstep(params)

    tm = GraphSAGE(10, 16, 4, num_layers=2, dropout=0.0, device="cpu")
    tm.load_state_dict(dt.from_flax_params(params))
    opt = torch.optim.Adam(tm.parameters(), lr=1e-3)
    logits = tm(mb.blocks, mb.node_features["feat"])
    ce = F.cross_entropy(logits, torch.from_numpy(y), reduction="none")
    loss = (ce * torch.from_numpy(mask)).sum() / mask.sum()
    loss.backward()
    grads = {k: p.grad.clone() for k, p in tm.named_parameters()}
    opt.step()

    def close(got, want, what):
        want = np.asarray(want)
        np.testing.assert_allclose(np_of(got), want, rtol=1e-4,
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg=what)

    close(logits.detach(), jlogits, "logits")
    close(loss.detach(), jl, "loss")
    for tree, got in ((jgrads, grads), (jnew, dict(tm.state_dict()))):
        want = dt.from_flax_params(tree)
        assert set(got) == set(want)
        for k, v in got.items():
            close(v, want[k], k)


# ---------------------------------------------------------------------------
# the on-device backend
# ---------------------------------------------------------------------------


def check_mfg(mfg, indptr, indices, fanouts, seeds):
    """Every unmasked pick is an in-neighbour of its frontier node, a row
    of in-degree at most the fanout takes all its in-edges in CSC order,
    and each frontier is the previous one followed by its picks."""
    exact(mfg.frontiers[0], seeds)
    n = indptr.shape[0] - 1
    edges = set(zip(np.repeat(np.arange(n), np.diff(indptr)).tolist(),
                    indices.tolist()))
    live = np_of(mfg.seed_mask)
    for depth, fanout in enumerate(reversed(fanouts)):
        front = np_of(mfg.frontiers[depth])
        nbr, m = np_of(mfg.nbrs[depth]), np_of(mfg.masks[depth])
        assert nbr.shape == (front.shape[0], fanout)
        assert not m[~live].any()  # nothing under a masked node
        for i, j in zip(*np.nonzero(m)):
            assert (int(front[i]), int(nbr[i, j])) in edges
        deg = indptr[front + 1] - indptr[front]
        for i in np.nonzero((deg <= fanout) & live)[0]:
            want = indices[indptr[front[i]]:indptr[front[i] + 1]]
            exact(nbr[i, :deg[i]], want)
            assert m[i, :deg[i]].all() and not m[i, deg[i]:].any()
        exact(mfg.frontiers[depth + 1],
              np.concatenate([front, nbr.reshape(-1)]))
        live = np.concatenate([live, m.reshape(-1)])


def test_device_backend_pipeline_trains():
    """``test_device_backend_pipeline_trains`` with the backend asked on
    the CPU: ItemSampler -> DeviceNeighborSamplerStage ->
    DeviceFeatureFetcher -> DeviceSAGE, Adam; the picks are in-edges, the
    features the table's rows, the loss falls."""
    rng = np.random.default_rng(0)
    n, e, feat_dim, classes = 500, 4000, 16, 5
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    g = dt.graph((src, dst), num_nodes=n, device="cpu")
    feats = rng.normal(size=(n, feat_dim)).astype(np.float32)
    labels = torch.from_numpy(rng.integers(0, classes, n))
    rel = g._relation()
    indptr, indices = (np_of(a).astype(np.int64)
                       for a in (rel.csc_indptr, rel.csc_indices))
    dp = _seed_batches(tgb, np.arange(n), 64, shuffle=True, seed=0)
    dp = tgb.DeviceNeighborSamplerStage(dp, g, [4, 4], seed=1, device="cpu")
    assert dp.generator.device.type == "cpu"
    dp = tgb.DeviceFeatureFetcher(dp, {"feat": feats}, device="cpu")
    model = DeviceSAGE(feat_dim, 32, classes, num_layers=2,
                       generator=torch.Generator().manual_seed(0),
                       device="cpu")
    opt = torch.optim.Adam(model.parameters(), lr=1e-2)
    losses = []
    for epoch in range(3):
        for i, mb in enumerate(tgb.DataLoader(dp)):
            mfg = mb.device_mfg
            assert mfg.num_layers == 2
            x = mb.node_features["feat"]
            exact(x, feats[np_of(mfg.input_nodes())])
            exact(mb.input_nodes, mfg.input_nodes())
            if epoch == 0 and i < 2:
                check_mfg(mfg, indptr, indices, [4, 4], np_of(mb.seeds))
            loss = F.cross_entropy(model(mfg, x),
                                   labels[np_of(mb.seeds)])
            opt.zero_grad()
            loss.backward()
            opt.step()
            losses.append(loss.item())
    assert len(losses) == 24 and np.isfinite(losses).all()
    assert np.mean(losses[-8:]) < np.mean(losses[:8])
