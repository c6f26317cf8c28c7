"""The port's distributed minibatch path (``dist_minibatch.py``,
``device_dist_sampler.py``) against ``dgl_tpu``'s.

The partitioned CSC and ``shard_rows`` are held exactly. The host
samplers and loaders give exactly the reference's blocks for the same
seed: both sides pick through the same native code
(``csrc/host_ops.cpp`` and the reference's library, loaded first under
``test_torch_sampling.reference_native``'s lock), and the port's ids are
int64 where the reference's are int32 (values equal). The device sampler
draws from ``torch.Generator``s, so it is held by invariants: every pick
an in-neighbour, the reference's shapes, and the exchanged bytes the
analytic count. The feature pull and the device sampler run on a 4-part
one-process mesh against the reference's ``shard_map`` on 4 of its
devices.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dgl_tpu
import dgl_tpu.distributed as jd
import dgl_tpu.parallel as jpar
import dgl_tpu_torch as dt
import dgl_tpu_torch.distributed as td
import dgl_tpu_torch.parallel as tpar

from test_torch_dataloading import same_output
from test_torch_graph_utils import np_of
from test_torch_sampling import reference_native

P = 4


@pytest.fixture(autouse=True, scope="module")
def _reference_native():
    reference_native()


def exact(got, ref, what="value"):
    g, r = np_of(got), np.asarray(ref)
    assert g.shape == r.shape, (what, g.shape, r.shape)
    assert np.array_equal(g, r), what


def graph_pair(n=200, e=1500, seed=0):
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    return (dgl_tpu.graph((src, dst), num_nodes=n),
            dt.graph((src, dst), num_nodes=n, device="cpu"))


@pytest.fixture(scope="module")
def pgs():
    jg, tg = graph_pair()
    parts = jd.random_partition_assignment(jg, P, seed=1)
    return (jd.PartitionedGraphCSC.build(jg, parts, P),
            td.PartitionedGraphCSC.build(tg, parts, P), jg, tg)


@pytest.mark.parametrize("kind", ["random", "metis"])
def test_partitioned_csc_and_shard_rows(kind):
    jg, tg = graph_pair(150, 900, seed=2)
    parts = (jd.random_partition_assignment(jg, P, seed=3) if kind ==
             "random" else np.asarray(jd.metis_partition_assignment(jg, P)))
    ref = jd.PartitionedGraphCSC.build(jg, parts, P)
    got = td.PartitionedGraphCSC.build(tg, torch.from_numpy(parts), P)
    for k in ("ranges", "order", "new_of_old"):
        exact(getattr(got, k), getattr(ref, k), k)
    for k in ("indptr", "indices", "eids"):
        for p in range(P):
            exact(getattr(got, k)[p], getattr(ref, k)[p], f"{k}[{p}]")
    assert got.n_max == ref.n_max and got.num_nodes == ref.num_nodes
    x = np.random.default_rng(4).normal(size=(150, 3)).astype(np.float32)
    exact(got.shard_rows(x, device="cpu"), np.asarray(ref.shard_rows(x)))
    exact(got.shard_rows(torch.from_numpy(x)), np.asarray(ref.shard_rows(x)))
    for v in (0, 77, 149):
        for a, b in zip(got.in_neighbors(v), ref.in_neighbors(v)):
            exact(a, b)


def unstack(stacked, p):
    return jax.tree_util.tree_map(lambda a: a[p], stacked)


@pytest.mark.parametrize("replace", [False, True])
def test_dist_neighbor_sampler_blocks(pgs, replace):
    jpg, tpg, _, _ = pgs
    js = jd.DistNeighborSampler(jpg, [3, 4], batch_size=10,
                                replace=replace, seed=5)
    ts = td.DistNeighborSampler(tpg, [3, 4], batch_size=10,
                                replace=replace, seed=5, device="cpu")
    for seeds in (np.array([0, 57, 120, 199, 3, 88]),
                  np.arange(190, 200)):
        ref = js.sample_blocks(seeds)
        got = ts.sample_blocks(torch.from_numpy(seeds))
        exact(got[0], ref[0], "input nodes")
        exact(got[1], ref[1], "output nodes")
        same_output(got[2], ref[2], "blocks")
    with pytest.raises(dt.DGLError):
        ts.sample_blocks(np.arange(11))


def test_dist_node_dataloader(pgs):
    jpg, tpg, _, _ = pgs
    train = np.arange(0, 200, 3)
    jl = jd.DistNodeDataLoader(
        jpg, train, jd.DistNeighborSampler(jpg, [2, 3], 8, seed=6), 8,
        seed=7)
    tl = td.DistNodeDataLoader(
        tpg, train, td.DistNeighborSampler(tpg, [2, 3], 8, seed=6,
                                           device="cpu"), 8, seed=7)
    assert len(tl) == len(jl)
    for (ti, to, tb), (ji, jo, jb) in zip(tl, jl):
        exact(ti, ji, "input")
        exact(to, jo, "output")
        assert ti.dtype == torch.int64 and len(tb) == 2
        for layer in range(2):
            for p in range(P):
                same_output(tb[layer][p], unstack(jb[layer], p),
                            f"block {layer} part {p}")
    exact(np.concatenate(td.node_split_by_owner(train, tpg.ranges, P)),
          np.concatenate(jd.dist_minibatch.node_split_by_owner(
              train, jpg.ranges, P)))
    blocks = [[1, 2], [3, 4], [5, 6]]
    assert td.stack_blocks(blocks) == [[1, 3, 5], [2, 4, 6]]


def test_dist_edge_dataloader(pgs):
    jpg, tpg, jg, _ = pgs
    src, dst = (np.asarray(a) for a in jg.edges())
    edges = np.stack([jpg.new_of_old[src[::5]], jpg.new_of_old[dst[::5]]], 1)
    jl = jd.DistEdgeDataLoader(jpg, edges, [3], batch_size=4,
                               num_negatives=2, seed=8)
    tl = td.DistEdgeDataLoader(tpg, torch.from_numpy(edges), [3],
                               batch_size=4, num_negatives=2, seed=8,
                               device="cpu")
    # the reference's block sampler is built without a seed: give both the
    # same generator
    jl.sampler._rng = np.random.default_rng(9)
    tl.sampler._rng = np.random.default_rng(9)
    assert len(tl) == len(jl)
    for step, (got, ref) in enumerate(zip(tl, jl)):
        for i, what in enumerate(("pos", "neg", "seeds", "pos_idx",
                                  "neg_idx", "input")):
            exact(got[i], ref[i], what)
        for p in range(P):
            same_output(got[6][0][p], unstack(ref[6][0], p), f"part {p}")
        if step == 1:
            break
    with pytest.raises(dt.DGLError):
        td.DistEdgeDataLoader(tpg, np.zeros(3), [2], 2, device="cpu")


def test_dist_etype_sampler(pgs):
    jpg, tpg, _, _ = pgs
    E = sum(ix.shape[0] for ix in jpg.indices)
    etypes = np.random.default_rng(10).integers(0, 3, E)
    fan = [[1, 2, 1], [2, 0, 1]]
    js = jd.DistEtypeNeighborSampler(jpg, etypes, fan, 6, seed=11)
    ts = td.DistEtypeNeighborSampler(tpg, torch.from_numpy(etypes), fan, 6,
                                     seed=11, device="cpu")
    assert ts.layer_caps() == js.layer_caps()
    for layer in range(2):
        exact(ts.slot_etypes(layer), js.slot_etypes(layer))
    for seeds in (np.array([1, 50, 101, 150]), np.arange(150, 156)):
        ref = js.sample_blocks(seeds)
        got = ts.sample_blocks(seeds)
        exact(got[0], ref[0])
        same_output(got[2], ref[2], "etype blocks")


@pytest.fixture(scope="module")
def meshes():
    return (jpar.create_mesh((P,), ("gp",), devices=jax.devices()[:P]),
            tpar.create_mesh((P,), ("gp",), device="cpu"))


def test_pull_rows_in_shard_map(pgs, meshes):
    from jax.sharding import PartitionSpec as JP

    try:
        from jax import shard_map
    except ImportError:  # pragma: no cover
        from jax.experimental.shard_map import shard_map
    jpg, tpg, _, _ = pgs
    jm, tm = meshes
    rng = np.random.default_rng(12)
    x = rng.normal(size=(200, 5)).astype(np.float32)
    ids = rng.integers(0, 200, (P, 9))
    ids[1, 3] = -1  # padding: a masked slot downstream
    table = np.asarray(jpg.shard_rows(x))
    run = jax.jit(shard_map(
        lambda t, i: jd.pull_rows_in_shard_map(jpg.ranges, t[0], i[0],
                                               "gp")[None],
        mesh=jm, in_specs=(JP("gp"), JP("gp")), out_specs=JP("gp")))
    ref = run(table, ids)
    tm.reset_comm_bytes()
    got = td.pull_rows_in_shard_map(tm, tpg.ranges,
                                    tpg.shard_rows(x, device="cpu"),
                                    torch.from_numpy(ids))
    ok = ids >= 0
    exact(np_of(got)[ok], np.asarray(ref)[ok], "pulled rows")
    exact(np_of(got)[ok], x[tpg.order[ids[ok]]], "against the table")
    # one int32 (P, B) request and one (P, B, F) float32 response a part
    assert tm.comm_bytes == {"int": P * 9 * 4, "float": P * 9 * 5 * 4}


def _global_csc(pg):
    """The whole graph's CSC over the new ids (the parts' CSCs end to
    end)."""
    offs = np.concatenate([[0], np.cumsum([ix.shape[0]
                                           for ix in pg.indices])])
    indptr = np.concatenate([pg.indptr[p][:-1] + offs[p]
                             for p in range(pg.num_parts)] + [[offs[-1]]])
    return (torch.from_numpy(indptr.astype(np.int64)),
            torch.from_numpy(np.concatenate(pg.indices).astype(np.int64)))


def check_picks(mfg, part, indptr, indices, fanouts):
    """Every unmasked pick of part ``part`` an in-neighbour of its
    frontier node; a live row of degree <= fanout takes all, in order;
    no mask past the degree or under a masked node."""
    n, e = indptr.shape[0] - 1, indices.shape[0]
    deg_all = indptr[1:] - indptr[:-1]
    dst = torch.repeat_interleave(torch.arange(n), deg_all)
    keys = torch.sort(dst * n + indices).values
    live = mfg.seed_mask[part]
    for depth, fanout in enumerate(reversed(fanouts)):
        front = mfg.frontiers[depth][part].long()
        nbr, m = mfg.nbrs[depth][part].long(), mfg.masks[depth][part]
        q = (front[:, None] * n + nbr)[m]
        assert (keys[torch.searchsorted(keys, q).clamp(max=e - 1)] == q).all()
        start = indptr[front]
        deg = indptr[front + 1] - start
        j = torch.arange(fanout)[None, :]
        inside = j < deg[:, None]
        small = (deg <= fanout) & live
        want = indices[(start[:, None] + j).clamp(max=e - 1)]
        assert not (m & ~inside).any() and not (m & ~live[:, None]).any()
        assert not (small[:, None] & inside & ~m).any()
        assert not (small[:, None] & inside & (nbr != want)).any()
        live = torch.cat([live, m.reshape(-1)])


@pytest.mark.parametrize("mode", ["unique", "replace", "exact"])
def test_device_dist_sampler_invariants(pgs, meshes, mode):
    from jax.sharding import PartitionSpec as JP

    try:
        from jax import shard_map
    except ImportError:  # pragma: no cover
        from jax.experimental.shard_map import shard_map
    jpg, tpg, _, _ = pgs
    jm, tm = meshes
    fanouts, B = [3, 2, 4], 5
    rng = np.random.default_rng(13)
    seeds = rng.integers(0, 200, (P, B)).astype(np.int32)
    smask = rng.random((P, B)) > 0.2
    jip, jix = jd.shard_csc_arrays(jpg)
    tip, tix = td.shard_csc_arrays(tpg, device="cpu")
    exact(tip, np.asarray(jip))
    exact(tix, np.asarray(jix))
    js = jd.DeviceDistSampler(fanouts, jpg.ranges, mode=mode)
    ts = td.DeviceDistSampler(fanouts, tpg.ranges, mode=mode)
    assert ts.comm_bytes_per_sample(B, P) == js.comm_bytes_per_sample(B, P)
    keys = jax.random.split(jax.random.PRNGKey(0), P)

    def body(k, ip, ix, sd, sm):
        mfg = js.sample_shard(k[0], ip[0], ix[0], sd[0], "gp",
                              seed_mask=sm[0])
        return tuple(a[None] for a in mfg.nbrs + mfg.masks)

    ref = jax.jit(shard_map(body, mesh=jm, in_specs=(JP("gp"),) * 5,
                            out_specs=JP("gp")))(keys, jip, jix, seeds,
                                                 smask)
    gens = [torch.Generator().manual_seed(20 + p) for p in range(P)]
    tm.reset_comm_bytes()
    mfg = ts.sample_shard(tm, gens, tip, tix, torch.from_numpy(seeds),
                          seed_mask=torch.from_numpy(smask))
    for a, b in zip(mfg.nbrs + mfg.masks, ref):
        assert tuple(a.shape) == tuple(b.shape)
        assert np_of(a).dtype.kind == np.asarray(b).dtype.kind
    assert tm.comm_bytes == {"int": ts.comm_bytes_per_sample(B, P),
                             "float": 0}
    indptr, indices = _global_csc(tpg)
    for p in range(P):
        check_picks(mfg, p, indptr, indices, fanouts)
        exact(mfg.frontiers[0][p], seeds[p])
    assert mfg.input_nodes().shape == (P, B * 4 * 3 * 5)
