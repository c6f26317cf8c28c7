"""The port's dataloading (``dgl_tpu_torch.dataloading``) against
``dgl_tpu.dataloading``, on the same numpy graphs and seeds.

The picks are the same on both sides (``test_torch_sampling.py`` says
why), so blocks, pair graphs, subgraphs, batches and ids are held exactly,
frames at rtol = atol = 1e-6 (``same_graph``). The ragged samplers' blocks
are built from the picks directly on a graph of one type; they are held
against the reference's ``to_block`` of the frontier. One GraphSAGE
training step over ragged blocks (the reference's weights carried by
``from_flax_params``): logits, loss, every gradient and the parameters
after one SGD step at rtol = 1e-4, atol = 1e-5 * max|ref| (f32 sums in
another order, as ``test_torch_minibatch.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

import dgl_tpu
from dgl_tpu import dataloading as jdl
from dgl_tpu.models import GraphSAGE as JGraphSAGE
import dgl_tpu_torch as dt
from dgl_tpu_torch import dataloading as tdl
from dgl_tpu_torch.base import EID, NID, DGLError
from dgl_tpu_torch.models import GraphSAGE

from test_torch_graph_utils import assert_same, np_of, same_graph
from test_torch_sampling import homo_graphs, reference_native


@pytest.fixture(autouse=True, scope="module")
def _reference_native():
    reference_native()


N, E = 300, 3000


@pytest.fixture(scope="module")
def graphs():
    jg, tg = homo_graphs(N, E, seed=20)
    labels = np.random.default_rng(21).integers(0, 4, N)
    jg.ndata["label"] = jnp.asarray(labels)
    tg.ndata["label"] = torch.from_numpy(labels)
    return jg, tg


def same_output(got, ref, what="output"):
    """A sampler's or loader's output: graphs by ``same_graph``, lists and
    tuples item by item, ids exactly."""
    if isinstance(ref, dgl_tpu.Graph):
        same_graph(got, ref, what, batch=False)
    elif isinstance(ref, (list, tuple)):
        assert len(got) == len(ref), what
        for i, (a, b) in enumerate(zip(got, ref)):
            same_output(a, b, f"{what}[{i}]")
    elif isinstance(ref, dict):
        assert set(got) == set(ref), what
        for k in ref:
            same_output(got[k], ref[k], f"{what}[{k!r}]")
    else:
        assert_same(got, ref, what)


SEEDS = np.array([5, 0, 17, 150, 299, 42])

RAGGED = {
    "neighbor": lambda m: m.NeighborSampler([3, 5], seed=1),
    "neighbor_alias": lambda m: m.MultiLayerNeighborSampler([4], seed=2),
    "replace": lambda m: m.NeighborSampler([3, 5], replace=True, seed=1),
    "prob": lambda m: m.NeighborSampler([3, 5], prob="p", seed=1),
    "out": lambda m: m.NeighborSampler([4, 4], edge_dir="out", seed=1),
    "full": lambda m: m.MultiLayerFullNeighborSampler(2),
    "labor": lambda m: m.LaborSampler([3, 5], seed=3),
    "labor_i": lambda m: m.LaborSampler([3, 5], importance_sampling=1,
                                        seed=3),
    "labor_prob": lambda m: m.LaborSampler([4], prob="p", seed=4),
}


@pytest.mark.parametrize("case", sorted(RAGGED))
def test_ragged_blocks_match_reference(graphs, case):
    """Two successive batches (the sampler's generator advances), then
    one with excluded edges."""
    jg, tg = graphs
    js, ts = RAGGED[case](jdl), RAGGED[case](tdl)
    for seeds, excl in ((SEEDS, None), ((SEEDS[::-1] + 1) % N, None),
                        (SEEDS, np.arange(0, E, 5))):
        if excl is not None and case.startswith("labor"):
            excl = None  # LABOR takes no exclusion
        ref = js.sample_blocks(jg, seeds, exclude_eids=excl)
        got = ts.sample_blocks(tg, torch.from_numpy(seeds),
                               exclude_eids=excl)
        same_output(got, ref, case)
        assert got[0].dtype == torch.int64 and got[1].dtype == torch.int64


def test_ragged_blocks_of_a_heterograph_and_a_renamed_type():
    """A graph of several types takes ``to_block`` of the frontier; a
    graph of one type under other names keeps its names."""
    from test_torch_graph_utils import hetero_pair

    jg, tg = hetero_pair()
    seeds = {"item": np.array([1, 4])}
    fan = {("user", "buys", "item"): 2, ("item", "bought_by", "user"): 2,
           ("item", "has", "tag"): 2}
    # the reference's sampler takes no dict of seeds: hold the port's
    # against the composition it runs a layer
    from dgl_tpu.sampling import sample_neighbors
    from dgl_tpu.transforms import to_block

    layer_seed = int(np.random.default_rng(0).integers(2**31))
    ref = to_block(sample_neighbors(jg, seeds, fan, seed=layer_seed), seeds)
    got = tdl.NeighborSampler([fan], seed=0).sample_blocks(tg, seeds)
    same_output(got[2], [ref])
    assert_same(got[0], {nt: ref._node_frames[nt][NID]
                         for nt in ref.srctypes})
    src, dst = np.array([0, 1, 2, 2, 3]), np.array([1, 2, 0, 1, 1])
    data = {("u", "follows", "u"): (src, dst)}
    jh = dgl_tpu.heterograph(data, {"u": 4})
    th = dt.heterograph(data, {"u": 4}, device="cpu")
    same_output(tdl.NeighborSampler([2], seed=0).sample_blocks(th, [1]),
                jdl.NeighborSampler([2], seed=0).sample_blocks(jh, [1]))


def _sage_inputs(tblocks, seed=22):
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(N, 10)).astype(np.float32)
    labels = rng.integers(0, 4, N).astype(np.int32)
    return (feats[np_of(tblocks[0].srcdata[NID])],
            labels[np_of(tblocks[-1].dstdata[NID])])


def test_graphsage_step_over_ragged_blocks(graphs):
    """DGL's ``node_classification.py`` step over ``NeighborSampler``
    blocks, against the reference's GraphSAGE on the reference's
    blocks."""
    jg, tg = graphs
    seeds = np.arange(0, N, 7)
    jblocks = jdl.NeighborSampler([4, 6], seed=5).sample_blocks(jg, seeds)[2]
    tblocks = tdl.NeighborSampler([4, 6], seed=5).sample_blocks(tg, seeds)[2]
    x, y = _sage_inputs(tblocks)
    jm = JGraphSAGE(10, 16, 4, num_layers=2, dropout=0.0)
    params = jm.init(jax.random.PRNGKey(0), jblocks, jnp.asarray(x))

    def jloss(p):
        logits = jm.apply(p, jblocks, jnp.asarray(x))
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(y)).mean(), logits

    (jl, jlogits), jgrads = jax.value_and_grad(jloss, has_aux=True)(params)
    tx = optax.sgd(1e-3)
    jnew = optax.apply_updates(params, tx.update(jgrads,
                                                 tx.init(params))[0])
    tm = GraphSAGE(10, 16, 4, num_layers=2, dropout=0.0, device="cpu")
    tm.load_state_dict(dt.from_flax_params(params))
    opt = torch.optim.SGD(tm.parameters(), lr=1e-3)
    logits = tm(tblocks, torch.from_numpy(x))
    loss = F.cross_entropy(logits, torch.from_numpy(y).long())
    loss.backward()
    grads = {k: p.grad.clone() for k, p in tm.named_parameters()}
    opt.step()

    def close(got, want, what):
        want = np.asarray(want)
        np.testing.assert_allclose(got, want, rtol=1e-4,
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg=what)

    assert logits.shape == (seeds.shape[0], 4)
    close(logits.detach().numpy(), jlogits, "logits")
    close(loss.item(), jl, "loss")
    for tree, got in ((jgrads, grads), (jnew, dict(tm.state_dict()))):
        want = dt.from_flax_params(tree)
        assert set(got) == set(want)
        for k, v in got.items():
            close(v.detach().numpy(), want[k].numpy(), k)


# ---------------------------------------------------------------------------
# edge prediction
# ---------------------------------------------------------------------------

EDGE_CASES = {
    "self_uniform": dict(exclude="self", negative_sampler="uniform"),
    "reverse_id": dict(exclude="reverse_id", negative_sampler="uniform"),
    "global": dict(exclude=None, negative_sampler="global"),
    "no_negative": dict(exclude="self"),
    "spot_target": dict(exclude="spot", negative_sampler="per_source"),
}


def _edge_sampler(m, g, case, reverse):
    kw = dict(EDGE_CASES[case])
    neg = kw.pop("negative_sampler", None)
    kw["negative_sampler"] = {
        None: lambda: None, "uniform": lambda: m.Uniform(2, seed=6),
        "per_source": lambda: m.PerSourceUniform(1, seed=6),
        "global": lambda: m.GlobalUniform(2, seed=6)}[neg]()
    if kw["exclude"] == "reverse_id":
        kw["reverse_eids"] = reverse
    if kw["exclude"] == "spot":
        kw["exclude"] = m.SpotTarget(g, exclude="reverse_id",
                                     degree_threshold=12,
                                     reverse_eids=reverse)
    return m.as_edge_prediction_sampler(m.NeighborSampler([3, 4], seed=7),
                                        **kw)


@pytest.mark.parametrize("case", sorted(EDGE_CASES))
def test_edge_prediction_sampler(case):
    """Link prediction over a graph stored both ways, edge ``i``'s
    reverse ``i +- E/2`` (the products recipe's layout)."""
    src, dst = np.random.default_rng(23).integers(0, 200, (2, 800))
    both = (np.concatenate([src, dst]), np.concatenate([dst, src]))
    jg = dgl_tpu.graph(both, num_nodes=200)
    tg = dt.graph(both, num_nodes=200, device="cpu")
    reverse = np.concatenate([np.arange(800, 1600), np.arange(800)])
    js = _edge_sampler(jdl, jg, case, reverse)
    ts = _edge_sampler(tdl, tg, case, torch.from_numpy(reverse))
    for seed_edges in (np.arange(0, 1600, 97), np.arange(5, 60, 3)):
        ref = js.sample(jg, seed_edges)
        got = ts.sample(tg, torch.from_numpy(seed_edges))
        same_output(got, ref, case)
        if case == "reverse_id":
            for b in got[-1]:
                eids = np_of(b.edata[EID])
                assert not np.isin(eids, seed_edges).any()
                assert not np.isin(eids, reverse[seed_edges]).any()


def test_find_exclude_eids():
    data = {("u", "follows", "v"): ([0, 1, 2], [1, 2, 0]),
            ("v", "followed-by", "u"): ([1, 2, 0], [0, 1, 2])}
    jh = dgl_tpu.heterograph(data)
    th = dt.heterograph(data, device="cpu")
    seeds = {"follows": np.array([0, 2])}
    rev = {"follows": "followed-by"}
    assert_same(
        tdl.find_exclude_eids(th, seeds, "reverse_types",
                              reverse_etypes=rev),
        jdl.find_exclude_eids(jh, seeds, "reverse_types",
                              reverse_etypes=rev))
    for exclude in (None, "self", lambda e: e[::2]):
        assert_same(tdl.find_exclude_eids(th, np.arange(3), exclude),
                    jdl.find_exclude_eids(jh, np.arange(3), exclude))
    for mode in ("reverse_types", "reverse_id", "bogus"):
        with pytest.raises(DGLError):
            tdl.find_exclude_eids(th, seeds, mode)


# ---------------------------------------------------------------------------
# DataLoader, datasets and collators
# ---------------------------------------------------------------------------

LOADER_CASES = {
    "prefetch": dict(use_prefetch_thread=True),
    "inline": dict(use_prefetch_thread=False),
    "drop_last": dict(drop_last=True),
    "ddp": dict(ddp_rank=1, ddp_world_size=2),
}


@pytest.mark.parametrize("case", sorted(LOADER_CASES))
def test_dataloader_matches_reference(graphs, case):
    jg, tg = graphs
    kw = LOADER_CASES[case]
    ref = list(jdl.DataLoader(jg, np.arange(100), jdl.NeighborSampler(
        [2, 3], seed=8), batch_size=32, shuffle=True, seed=9, **kw))
    loader = tdl.DataLoader(tg, torch.arange(100), tdl.NeighborSampler(
        [2, 3], seed=8), batch_size=32, shuffle=True, seed=9, device="cpu",
        **kw)
    got = list(loader)
    assert len(got) == len(ref) == len(loader)
    same_output(got, ref, case)


def test_dataloader_thread_pool_and_early_stop(graphs):
    """Several sampling threads give every batch in order (each sampler's
    own generator then advances in the order the threads reach it); a
    consumer that stops early releases the prefetch thread."""
    import threading

    _, tg = graphs
    loader = tdl.DataLoader(tg, np.arange(100), tdl.FixedShapeNeighborSampler(
        [2, 3], 32, seed=8, device="cpu"), batch_size=32, num_workers=3,
        device="cpu")
    outs = [np_of(o) for _, o, _ in loader]
    assert_same(outs, [np.arange(100)[lo:lo + 32]
                       for lo in range(0, 100, 32)])
    before = threading.active_count()
    loader = tdl.DataLoader(tg, np.arange(300), tdl.NeighborSampler([2]),
                            batch_size=10, device="cpu")
    for i, _ in enumerate(loader):
        if i == 2:
            break
    assert threading.active_count() == before
    failing = tdl.DataLoader(tg, np.array([N + 5]), tdl.NeighborSampler([2]),
                             device="cpu")
    with pytest.raises(ValueError, match="seed ids"):
        list(failing)


def test_tensorized_datasets_and_collators(graphs):
    jg, tg = graphs
    for args, kw in (((np.arange(10), 3), {}),
                     ((np.arange(10), 3), dict(drop_last=True)),
                     ((np.arange(10), 3), dict(shuffle=True, seed=2)),
                     (({"a": np.arange(2), "b": np.arange(3)}, 2), {})):
        ref = jdl.TensorizedDataset(*args, **kw)
        got = tdl.TensorizedDataset(*args, **kw)
        assert len(got) == len(ref)
        assert_same(list(got), list(ref))
    for r in range(3):
        for kw in (dict(), dict(drop_last=True), dict(shuffle=True, seed=1)):
            ref = jdl.DDPTensorizedDataset(np.arange(10), 2, rank=r,
                                           world_size=3, **kw)
            got = tdl.DDPTensorizedDataset(np.arange(10), 2, rank=r,
                                           world_size=3, **kw)
            assert len(got) == len(ref)
            assert_same(list(got), list(ref))
    solo = tdl.create_tensorized_dataset(np.arange(8), 2, use_ddp=True)
    assert (solo.rank, solo.world_size) == (0, 1)  # no process group
    node = tdl.NodeCollator(tg, np.arange(10), tdl.NeighborSampler([3, 3],
                                                                   seed=0))
    same_output(node.collate([0, 1, 2]), jdl.NodeCollator(
        jg, np.arange(10), jdl.NeighborSampler([3, 3], seed=0)).collate(
            [0, 1, 2]))
    edge = [m.EdgeCollator(g, np.arange(E), m.NeighborSampler([3], seed=0),
                           exclude="self", negative_sampler=m.Uniform(
                               2, seed=0))
            for m, g in ((jdl, jg), (tdl, tg))]
    same_output(edge[1].collate([0, 5, 9]), edge[0].collate([0, 5, 9]))
    gs = [(dgl_tpu.graph(([0, i % 3], [1, 2]), num_nodes=3),
           dt.graph(([0, i % 3], [1, 2]), num_nodes=3, device="cpu"))
          for i in range(4)]
    labels = np.arange(4.0)
    ref = jdl.GraphCollator().collate(list(zip([a for a, _ in gs], labels)))
    got = tdl.GraphCollator(device="cpu").collate(
        list(zip([b for _, b in gs], labels)))
    same_graph(got[0], ref[0])
    assert_same(got[1], ref[1])


@pytest.mark.parametrize("pad", [True, False])
def test_graph_dataloader(pad):
    rng = np.random.default_rng(24)
    sizes = rng.integers(3, 9, 10)
    pairs = []
    for i, n in enumerate(sizes):
        src, dst = rng.integers(0, n, (2, 2 * n))
        x = rng.normal(size=(n, 2)).astype(np.float32)
        jg = dgl_tpu.graph((src, dst), num_nodes=int(n))
        tg = dt.graph((src, dst), num_nodes=int(n), device="cpu")
        jg.ndata["x"], tg.ndata["x"] = jnp.asarray(x), torch.from_numpy(x)
        pairs.append(((jg, i % 3), (tg, i % 3)))
    ref = list(jdl.GraphDataLoader([a for a, _ in pairs], batch_size=4,
                                   shuffle=True, seed=1, pad=pad))
    loader = tdl.GraphDataLoader([b for _, b in pairs], batch_size=4,
                                 shuffle=True, seed=1, pad=pad, device="cpu")
    got = list(loader)
    assert len(got) == len(ref) == len(loader) == 3
    for (tb, tl, tm), (jb, jl, jm) in zip(got, ref):
        same_graph(tb, jb)
        assert_same(tl, jl)
        assert_same(tm, jm)


# ---------------------------------------------------------------------------
# subgraph samplers, SpotTarget, worker helpers
# ---------------------------------------------------------------------------

SUBGRAPH_CASES = {
    "saint_node": lambda m: (m.SAINTSampler("node", 60, seed=1), None),
    "saint_edge": lambda m: (m.SAINTSampler("edge", 200, seed=1), None),
    "saint_walk": lambda m: (m.SAINTSampler("walk", (10, 4), seed=1), None),
    "shadow": lambda m: (m.ShaDowKHopSampler([3, 2], seed=2), SEEDS),
    "shadow_prob": lambda m: (m.ShaDowKHopSampler([4], prob="p", seed=2),
                              SEEDS),
    "capped": lambda m: (m.CappedNeighborSampler([5, 5], 40, False,
                                                 seed=3), SEEDS),
    "capped_upsample": lambda m: (m.CappedNeighborSampler(
        [4, 4], 30, True, replace=True, seed=3), SEEDS),
}


@pytest.mark.parametrize("case", sorted(SUBGRAPH_CASES))
def test_subgraph_samplers(graphs, case):
    jg, tg = graphs
    (js, seeds), (ts, _) = SUBGRAPH_CASES[case](jdl), SUBGRAPH_CASES[case](
        tdl)
    for _ in range(2):
        if seeds is None:
            same_output(ts.sample(tg), js.sample(jg), case)
        else:
            same_output(ts.sample(tg, seeds), js.sample(jg, seeds), case)


def test_capped_sampler_on_a_heterograph_with_exclusion():
    from test_torch_graph_utils import hetero_pair

    jg, tg = hetero_pair()
    seeds = {"item": np.array([0, 3]), "user": np.array([1])}
    excl = {("user", "buys", "item"): np.arange(0, 20, 2)}
    kw = dict(fixed_k=6, upsample_rare_types=True, seed=5)
    ref = jdl.CappedNeighborSampler([2, 2], **kw).sample(jg, seeds, excl)
    got = tdl.CappedNeighborSampler([2, 2], **kw).sample(tg, seeds, excl)
    same_output(got, ref)


def test_worker_storage_columns(graphs):
    from dgl_tpu.subgraph import edge_subgraph as jsub

    jg, tg = graphs
    sub = dt.edge_subgraph(tg, np.arange(50), relabel_nodes=False)
    assert sub.ndata["h"] is tg.ndata["h"]
    stripped = tdl.remove_parent_storage_columns(sub, tg)
    assert isinstance(stripped._node_frames["_N"]["h"], tuple)
    restored = tdl.restore_parent_storage_columns(stripped, tg)
    assert restored.ndata["h"] is tg.ndata["h"]
    assert tdl.remove_parent_storage_columns(5, tg) == 5
    sampler = tdl.NeighborSampler([3], seed=0)
    ref = jdl.CollateWrapper(
        lambda g, items: jdl.NeighborSampler([3], seed=0).sample_blocks(
            g, np.asarray(items)), jg)([0, 1, 2])
    got = tdl.CollateWrapper(
        lambda g, items: sampler.sample_blocks(g, np.asarray(items)),
        tg)([0, 1, 2])
    same_output(got, ref)
    jsub(jg, np.arange(3))  # the reference's module stays importable
    np.random.seed(0)
    jdl.WorkerInitWrapper()(3)
    want = np.random.random()
    calls = []
    tdl.WorkerInitWrapper(calls.append)(3)
    assert np.random.random() == want and calls == [3]
