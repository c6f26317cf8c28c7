"""The port's distributed example programs against the JAX package's
scripts, on 8 parts: the JAX scripts over conftest.py's 8-device CPU
mesh, the port's over its one-process mesh of 8 parts.

For each script: the partition, the shards or the part-major CSC, the
sharded tables and every drawn array equal the JAX script's exactly; the
first loader batch (after the batch both scripts draw to initialise their
model) is equal, its blocks part by part; the first step's loss and every
gradient agree within rtol = 1e-4, atol = 1e-4 * max|ref| (the same f32
operations in another order), the JAX script's parameters carried over
by ``from_flax_params``. ``device_dist_sage`` samples on the device from
torch's generators, not JAX's: its first MFGs are handed to the
reference's model as its own. The JAX loaders shuffle from an unseeded
generator, and the JAX edge loader's block sampler is unseeded: both
sides get the same seeded generator here. Then each port script's
``main([..., "--device", "cpu"])`` runs at a few epochs or steps, its
losses finite and falling.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh

import dgl_tpu as jdgl
import dgl_tpu.data as J
import dgl_tpu.distributed as jd
from dgl_tpu.distributed.dist_spmm import shard_arrays as j_shard_arrays
from dgl_tpu.parallel import create_mesh as j_create_mesh
import dgl_tpu_torch as dt
from dgl_tpu_torch.examples import (cooperative_minibatch, device_dist_sage,
                                    distributed_hetero_rgcn,
                                    distributed_link_prediction,
                                    distributed_rgcn_minibatch,
                                    distributed_sage,
                                    distributed_sage_minibatch)
from dgl_tpu_torch.examples._common import dist_mesh

from test_torch_data import same_array
from test_torch_dataloading import same_output
from test_torch_examples_fullgraph import (CPU, _download_dir, _one_thread,
                                           held_step, jvg, load_flax, trains)
from test_torch_sampling import reference_native

__all__ = ["_download_dir", "_one_thread"]  # module fixtures, used here too

P = 8


@pytest.fixture(autouse=True, scope="module")
def _reference_native():
    reference_native()


def unstack(stacked, p):
    return jax.tree_util.tree_map(lambda a: a[p], stacked)


def same_pg(tpg, jpg):
    for k in ("ranges", "order", "new_of_old"):
        same_array(getattr(tpg, k), getattr(jpg, k), k)
    for k in ("indptr", "indices"):
        for p in range(P):
            same_array(getattr(tpg, k)[p], getattr(jpg, k)[p], f"{k}[{p}]")


def same_batch(got, ref, what):
    """A distributed loader's batch: ids exactly, blocks part by part."""
    for i, (a, b) in enumerate(zip(got, ref)):
        if isinstance(a, list):
            for layer, (ta, jb) in enumerate(zip(a, b)):
                for p in range(P):
                    same_output(ta[p], unstack(jb, p),
                                f"{what}: block {layer} part {p}")
        else:
            same_array(a, b, f"{what}[{i}]")


def jce(logits, y):
    return optax.softmax_cross_entropy_with_integer_labels(logits, y)


def tmesh(axis):
    return dist_mesh(P, axis, "cpu")


# -- distributed_sage.py ---------------------------------------------------


def test_distributed_sage(capsys):
    mesh = j_create_mesh((P,), ("gp",))
    jg = J.SyntheticDataset(num_nodes=4096, num_edges=40_000, num_classes=8,
                            feat_dim=64)[0]
    jparts = jd.metis_partition_assignment(jg, P)
    jshards = jd.build_shards(jg, jparts, P)
    tables = j_shard_arrays(mesh, jshards)
    jx = jshards.shard_features(np.asarray(jg.ndata["feat"]))
    jy = jshards.shard_features(np.asarray(jg.ndata["label"])[:, None]
                                .astype(np.int32))[..., 0]
    jm = jshards.shard_features(np.asarray(jg.ndata["train_mask"])[:, None]
                                .astype(np.float32))[..., 0]
    m = tmesh("gp")
    g, parts, shards, ttables, x, y, tm = distributed_sage.setup(m, "cpu")
    same_array(parts, jparts, "the assignment")
    assert (shards.n_max, shards.e_max, shards.h_max) == (
        jshards.n_max, jshards.e_max, jshards.h_max)
    for k in ("src_ext", "dst_local", "send_idx", "send_mask"):
        same_array(getattr(shards, k), getattr(jshards, k), k)
    for a, b, what in ((x, jx, "x"), (y, jy, "y"), (tm, jm, "mask")):
        same_array(a, b, what)
    rng = np.random.default_rng(0)
    params = {"w1": jnp.asarray(rng.normal(size=(64, 64)) * 0.1,
                                jnp.float32),
              "w2": jnp.asarray(rng.normal(size=(64, 8)) * 0.1,
                                jnp.float32)}

    def jloss(p):
        h = jd.dist_copy_u_sum(mesh, jshards, jx, tables=tables, mean=True)
        h = jax.nn.relu(h @ p["w1"])
        h = jd.dist_copy_u_sum(mesh, jshards, h, tables=tables, mean=True)
        ls = jce(h @ p["w2"], jy)
        return (ls * jm).sum() / jnp.maximum(jm.sum(), 1)

    jl, jgrads = jvg(jloss)(params)
    w = distributed_sage.Weights("cpu")
    same_array(w.w1, params["w1"], "w1")
    count = int(g.ndata["train_mask"].sum())
    loss = distributed_sage.part_losses(m, shards, ttables, w, x, y, tm,
                                        count).sum()
    loss.backward()
    held_step(loss, w, jl, jgrads)
    res = distributed_sage.main(["--epochs", "3"] + CPU)
    assert len(trains(res)) == 3
    assert "mesh: 8 devices over axis 'gp'" in capsys.readouterr().out


# -- distributed_hetero_rgcn.py --------------------------------------------


def test_distributed_hetero_rgcn(capsys):
    from dgl_tpu.distributed.hetero_shard import (build_hetero_shards,
                                                  dist_hetero_copy_u_sum)

    mesh = j_create_mesh((P,), ("gp",))
    jg = J.synthetic_hetero_graph()
    jassign = jd.partition.hetero_partition_assignment(jg, P)
    jshards = build_hetero_shards(jg, jassign, P)
    feats = {nt: np.asarray(jg._node_frames[nt]["feat"]) for nt in jg.ntypes}
    jx = jshards.shard_features(feats)
    jlab = jshards.shard_features({"paper": np.asarray(
        jg._node_frames["paper"]["label"])[:, None]})["paper"][..., 0]
    jlab = jlab.astype(jnp.int32)
    jmask = jshards.shard_features({"paper": np.asarray(
        jg._node_frames["paper"]["train_mask"]).astype(np.float32)[
            :, None]})["paper"][..., 0]
    m = tmesh("gp")
    g, shards, x, labels, mask = distributed_hetero_rgcn.setup(m, "cpu")
    assert shards.n_max == jshards.n_max and shards.h_max == jshards.h_max
    for nt in jg.ntypes:
        same_array(x[nt], jx[nt], nt)
    same_array(labels, jlab, "labels")
    same_array(mask, jmask, "mask")
    rng = np.random.default_rng(0)
    params = {"w1": {nt: jnp.asarray(rng.normal(size=(64, 32)) * 0.1,
                                     jnp.float32) for nt in jg.ntypes},
              "w2": {nt: jnp.asarray(rng.normal(size=(32, 8)) * 0.1,
                                     jnp.float32) for nt in jg.ntypes}}

    def jloss(p):
        h1 = dist_hetero_copy_u_sum(mesh, jshards, jx, mean=True)
        h1 = {nt: jax.nn.relu(v @ p["w1"][nt] + jx[nt] @ p["w1"][nt])
              for nt, v in h1.items()}
        h2 = dist_hetero_copy_u_sum(mesh, jshards, h1, mean=True)
        ls = jce(h2["paper"] @ p["w2"]["paper"], jlab)
        return (ls * jmask).sum() / jnp.maximum(jmask.sum(), 1)

    jl, jgrads = jvg(jloss)(params)
    w = distributed_hetero_rgcn.Weights(g.ntypes, "cpu")
    count = int(g.nodes["paper"].data["train_mask"].sum())
    loss = distributed_hetero_rgcn.part_losses(m, shards, w, x, labels,
                                               mask, count).sum()
    loss.backward()
    held_step(loss, w, jl, jgrads)
    res = distributed_hetero_rgcn.main(["--epochs", "3"] + CPU)
    assert len(trains(res)) == 3
    assert "final loss" in capsys.readouterr().out


# -- the host-sampled minibatch scripts ------------------------------------


def dp_mesh():
    return Mesh(np.array(jax.devices()), ("dp",))


def jpulled(mesh, jpg, ftable, ltable, in_ids, out_ids):
    x = jd.sparse_all_to_all_pull(mesh, jpg.ranges, ftable, in_ids,
                                  axis="dp")
    y = jd.sparse_all_to_all_pull(mesh, jpg.ranges, ltable,
                                  jnp.where(out_ids >= 0, out_ids, 0),
                                  axis="dp")[..., 0].astype(jnp.int32)
    return x, y


def jparts_loss(apply, blocks, x, y, out_ids):
    """The JAX scripts' loss: the model mapped over the parts' blocks."""
    def fwd(blks, xx):
        return apply(blks, xx * blks[0].srcdata["_mask"][:, None])

    logits = jax.vmap(fwd)(blocks, x)
    ls = jce(logits[:, : y.shape[1]], y)
    mm = (out_ids >= 0).astype(jnp.float32)
    return (ls * mm).sum() / jnp.maximum(mm.sum(), 1)


def test_distributed_sage_minibatch(capsys):
    from dgl_tpu.models import GraphSAGE as JSAGE

    mesh = dp_mesh()
    jg = J.SyntheticDataset(num_nodes=4096, num_edges=40_000, num_classes=8,
                            feat_dim=64)[0]
    jparts = jd.metis_partition_assignment(jg, P)
    jpg = jd.PartitionedGraphCSC.build(jg, np.asarray(jparts), P)
    x_old = np.asarray(jg.ndata["feat"], np.float32)
    train_old = np.nonzero(np.asarray(jg.ndata["train_mask"]))[0]
    jf = jpg.shard_rows(x_old)
    jlt = jpg.shard_rows(np.asarray(jg.ndata["label"], np.int32).astype(
        np.float32)[:, None])
    jloader = jd.DistNodeDataLoader(
        jpg, np.sort(jpg.new_of_old[train_old]),
        jd.DistNeighborSampler(jpg, [5, 5], batch_size=32, seed=0),
        batch_size=32, shuffle=True)
    m = tmesh("dp")
    ds, g, pg, ftable, ltable, loader = distributed_sage_minibatch.setup(
        m, 32, [5, 5], "cpu")
    same_pg(pg, jpg)
    same_array(ftable, jf, "feature table")
    same_array(ltable, jlt, "label table")
    jloader._rng, loader._rng = (np.random.default_rng(0),
                                 np.random.default_rng(0))
    next(iter(jloader)), next(iter(loader))
    jb, tb = next(iter(jloader)), next(iter(loader))
    same_batch(tb, jb, "the first batch")
    in_ids, out_ids, jblocks = jb
    jx, jy = jpulled(mesh, jpg, jf, jlt, in_ids, out_ids)
    jmodel = JSAGE(64, 64, 8, num_layers=2)
    params = jmodel.init(jax.random.PRNGKey(0), unstack(jblocks, 0), jx[0])
    jl, jgrads = jvg(lambda p: jparts_loss(
        lambda b, h: jmodel.apply(p, b, h), jblocks, jx, jy, out_ids))(
        params)
    model = load_flax(distributed_sage_minibatch.make_model(64, 8, 2, "cpu"),
                      params)
    inputs = distributed_sage_minibatch.batch_inputs(m, pg, ftable, ltable,
                                                     tb)
    same_array(inputs[1], jx, "pulled features")
    same_array(inputs[2], jy, "pulled labels")
    loss = distributed_sage_minibatch.part_losses(m, model, *inputs).sum()
    loss.backward()
    held_step(loss, model, jl, jgrads)
    res = distributed_sage_minibatch.main(["--epochs", "2"] + CPU)
    assert len(trains(res)) == 2
    assert "8 partitions, owned nodes" in capsys.readouterr().out


def test_distributed_link_prediction(capsys):
    from dgl_tpu.models import GraphSAGE as JSAGE

    mesh = dp_mesh()
    jg = J.SyntheticDataset(num_nodes=2048, num_edges=20_000, num_classes=4,
                            feat_dim=32)[0]
    jpg = jd.PartitionedGraphCSC.build(
        jg, np.asarray(jd.metis_partition_assignment(jg, P)), P)
    src, dst = (np.asarray(a) for a in jg.edges())
    train = np.arange(0, jg.num_edges(), 4)
    edges = np.stack([jpg.new_of_old[src[train]],
                      jpg.new_of_old[dst[train]]], 1)
    jf = jpg.shard_rows(np.asarray(jg.ndata["feat"], np.float32))
    jloader = jd.DistEdgeDataLoader(jpg, edges, fanouts=[5], batch_size=16,
                                    num_negatives=2, seed=0)
    m = tmesh("dp")
    g, pg, ftable, loader = distributed_link_prediction.setup(m, 16, [5], 2,
                                                              "cpu")
    same_pg(pg, jpg)
    same_array(ftable, jf, "feature table")
    # the reference's block sampler is built without a seed: give both
    # the same generator
    jloader.sampler._rng, loader.sampler._rng = (np.random.default_rng(9),
                                                 np.random.default_rng(9))
    next(iter(jloader)), next(iter(loader))
    jb, tb = next(iter(jloader)), next(iter(loader))
    same_batch(tb, jb, "the first batch")
    pos, neg, seeds, pidx, nidx, in_ids, jblocks = jb
    jx = jd.sparse_all_to_all_pull(mesh, jpg.ranges, jf, in_ids, axis="dp")
    jmodel = JSAGE(32, 32, 16, num_layers=1)
    params = jmodel.init(jax.random.PRNGKey(0), unstack(jblocks, 0), jx[0])

    def jloss(p):  # the script's own lines
        def fwd(blks, xx):
            return jmodel.apply(p, blks, xx * blks[0].srcdata["_mask"][:,
                                                                      None])

        h = jax.vmap(fwd)(jblocks, jx)
        pos_s = jax.vmap(lambda hr, a, b: (hr[a] * hr[b]).sum(-1))(
            h, pidx[..., 0], pidx[..., 1])
        neg_s = jax.vmap(lambda hr, pa, nb: (hr[pa][:, None, :]
                                              * hr[nb]).sum(-1))(
            h, pidx[..., 0], nidx)
        pos_m = (pos[..., 0] >= 0).astype(jnp.float32)
        per = (optax.sigmoid_binary_cross_entropy(pos_s,
                                                  jnp.ones_like(pos_s))
               + optax.sigmoid_binary_cross_entropy(
                   neg_s, jnp.zeros_like(neg_s)).mean(-1)) * pos_m
        return per.sum() / jnp.maximum(pos_m.sum(), 1)

    jl, jgrads = jvg(jloss)(params)
    model = load_flax(distributed_link_prediction.make_model(32, 1, "cpu"),
                      params)
    inputs = distributed_link_prediction.batch_inputs(m, pg, ftable, tb)
    loss = distributed_link_prediction.part_losses(m, model, *inputs).sum()
    loss.backward()
    held_step(loss, model, jl, jgrads)
    res = distributed_link_prediction.main(["--epochs", "2"] + CPU)
    assert len(trains(res)) == 2
    assert "epoch 1: loss" in capsys.readouterr().out


def test_distributed_rgcn_minibatch(capsys):
    from dgl_tpu import convert as jconvert
    from dgl_tpu.base import ETYPE as JETYPE, NTYPE as JNTYPE
    from dgl_tpu.nn import RelGraphConv as JRel

    mesh = dp_mesh()
    jds = J.SyntheticHeteroDataset()
    hg = jds[0]
    homo = jconvert.to_homogeneous(hg, ndata=["feat"])
    tpe = np.asarray(homo.edata[JETYPE])
    num_rels = len(hg.canonical_etypes)
    jpg = jd.PartitionedGraphCSC.build(
        homo, jd.metis_partition_assignment(homo, P), P)
    x_old = np.asarray(homo.ndata["feat"], np.float32)
    labels_old = np.zeros(homo.num_nodes(), np.float32)
    cat_old = np.nonzero(np.asarray(homo.ndata[JNTYPE])
                         == hg.ntypes.index(jds.predict_ntype))[0]
    labels_old[cat_old] = np.asarray(
        hg.nodes[jds.predict_ntype].data["label"], np.float32)
    jf, jlt = jpg.shard_rows(x_old), jpg.shard_rows(labels_old[:, None])
    jsampler = jd.DistEtypeNeighborSampler(jpg, tpe, [[4] * num_rels] * 2,
                                           batch_size=16, seed=0)
    jloader = jd.DistNodeDataLoader(jpg, np.sort(jpg.new_of_old[cat_old]),
                                    jsampler, batch_size=16, shuffle=True)
    m = tmesh("dp")
    (ds, thg, thomo, pg, ftable, ltable, loader,
     slot_et) = distributed_rgcn_minibatch.setup(m, 16, "cpu")
    same_pg(pg, jpg)
    same_array(ftable, jf, "feature table")
    same_array(ltable, jlt, "label table")
    for i in range(2):
        same_array(slot_et[i], jsampler.slot_etypes(i), f"slot etypes {i}")
    jloader._rng, loader._rng = (np.random.default_rng(0),
                                 np.random.default_rng(0))
    next(iter(jloader)), next(iter(loader))
    jb, tb = next(iter(jloader)), next(iter(loader))
    same_batch(tb, jb, "the first batch")
    in_ids, out_ids, jblocks = jb
    jx, jy = jpulled(mesh, jpg, jf, jlt, in_ids, out_ids)
    jslot = [jnp.asarray(jsampler.slot_etypes(i)) for i in range(2)]
    l1 = JRel(x_old.shape[1], 32, num_rels, self_loop=False)
    l2 = JRel(32, jds.num_classes, num_rels, self_loop=False)
    b0 = unstack(jblocks, 0)
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    p1 = l1.init(k1, b0[0], jx[0], jslot[0])
    p2 = l2.init(k2, b0[1], jax.nn.relu(l1.apply(p1, b0[0], jx[0],
                                                 jslot[0])), jslot[1])
    params = {"l1": p1["params"], "l2": p2["params"]}

    def apply(p, blocks, x):  # the script's RGCN.apply
        h = l1.apply({"params": p["l1"]}, blocks[0], x, jslot[0])
        h = jax.nn.relu(h) * blocks[1].srcdata["_mask"][:, None]
        return l2.apply({"params": p["l2"]}, blocks[1], h, jslot[1])

    jl, jgrads = jvg(lambda p: jparts_loss(
        lambda b, h: apply(p, b, h), jblocks, jx, jy, out_ids))(params)
    model = load_flax(distributed_rgcn_minibatch.make_model(
        x_old.shape[1], 32, jds.num_classes, num_rels, slot_et, "cpu"),
        params)
    inputs = distributed_sage_minibatch.batch_inputs(m, pg, ftable, ltable,
                                                     tb)
    loss = distributed_sage_minibatch.part_losses(m, model, *inputs).sum()
    loss.backward()
    held_step(loss, model, jl, jgrads)
    res = distributed_rgcn_minibatch.main(["--epochs", "2"] + CPU)
    assert len(res["losses"]) == 2 and np.all(np.isfinite(res["losses"]))
    assert "category='paper'" in capsys.readouterr().out


# -- device_dist_sage.py ---------------------------------------------------


def test_device_dist_sage(capsys):
    from dgl_tpu.models import DeviceSAGE as JDeviceSAGE
    from dgl_tpu.sampling.device_sampler import DeviceMFG as JMFG

    rng = np.random.default_rng(0)
    N, E = 20_000, 200_000
    src, dst = rng.integers(0, N, E), rng.integers(0, N, E)
    jg = jdgl.graph((src, dst), num_nodes=N)
    jpg = jd.PartitionedGraphCSC.build(
        jg, jd.metis_partition_assignment(jg, P), P)
    jip, jix = jd.shard_csc_arrays(jpg)
    jf = jpg.shard_rows(rng.normal(size=(N, 32)).astype(np.float32))
    jlt = jpg.shard_rows(rng.integers(0, 7, N).astype(np.float32)[:, None])
    jseeds = rng.integers(0, N, (P, 8, 128)).astype(np.int32)
    m = tmesh("dp")
    g, pg, ip, ix, feats, labels, seeds = device_dist_sage.setup(m, "cpu")
    same_pg(pg, jpg)
    for a, b, what in ((ip, jip, "indptr shards"), (ix, jix,
                                                    "indices shards"),
                       (feats, jf, "features"), (labels, jlt, "labels"),
                       (seeds, jseeds, "seeds")):
        same_array(a, b, what)
    sampler = dt.distributed.DeviceDistSampler([5, 5], pg.ranges)
    gens = [torch.Generator().manual_seed(2 + p) for p in range(P)]
    mfg = sampler.sample_shard(m, gens, ip, ix, seeds[:, 0], axis="dp")
    x = dt.distributed.pull_rows_in_shard_map(m, pg.ranges, feats,
                                              mfg.input_nodes(), axis="dp")
    y = dt.distributed.pull_rows_in_shard_map(m, pg.ranges, labels,
                                              seeds[:, 0],
                                              axis="dp")[..., 0].long()
    jmfgs = [JMFG(*[[jnp.asarray(t[p].numpy()) for t in part]
                    for part in (mfg.frontiers, mfg.nbrs, mfg.masks)],
                  jnp.asarray(mfg.seed_mask[p].numpy())) for p in range(P)]
    jx, jy = jnp.asarray(x.numpy()), jnp.asarray(y.numpy(), jnp.int32)
    jmodel = JDeviceSAGE(32, 64, 7, num_layers=2)
    params = jmodel.init(jax.random.PRNGKey(1), jmfgs[0], jx[0])

    def jloss(p):  # the ranks' mean loss, as pmean averages their grads
        return jnp.stack([jce(jmodel.apply(p, jmfgs[q], jx[q]), jy[q]).mean()
                          for q in range(P)]).mean()

    jl, jgrads = jvg(jloss)(params)
    model = load_flax(device_dist_sage.make_model("cpu"), params)
    loss = torch.stack([torch.nn.functional.cross_entropy(
        model(device_dist_sage.part_mfg(mfg, q), x[q]), y[q])
        for q in range(P)]).mean()
    loss.backward()
    held_step(loss, model, jl, jgrads)
    res = device_dist_sage.main(CPU)
    assert len(res["losses"]) == 8 and np.all(np.isfinite(res["losses"]))
    assert np.mean(res["losses"][-3:]) < res["losses"][0]
    assert "analytic comm:" in capsys.readouterr().out


# -- cooperative_minibatch.py ----------------------------------------------


def test_cooperative_minibatch(capsys):
    from dgl_tpu.base import NID as JNID
    from dgl_tpu.dataloading import FixedShapeNeighborSampler as JSampler
    from dgl_tpu.distributed.cooperative import sparse_all_to_all_pull
    from dgl_tpu.models import GraphSAGE as JSAGE
    from jax.sharding import NamedSharding, PartitionSpec

    mesh = j_create_mesh((P,), ("gp",))
    N, E, F, C, B = 4096, 40_000, 32, 8, 64
    rng = np.random.default_rng(0)
    jg = jdgl.graph((rng.integers(0, N, E), rng.integers(0, N, E)),
                    num_nodes=N)
    labels_np = (np.arange(N) % C).astype(np.int32)
    ranges = np.arange(P + 1) * (N // P)
    centroids = rng.normal(size=(C, F)).astype(np.float32)
    init = centroids[labels_np] + rng.normal(size=(N, F)).astype(
        np.float32) * 0.5
    table = jax.device_put(jnp.asarray(init.reshape(P, N // P, F)),
                           NamedSharding(mesh, PartitionSpec("gp")))
    jsampler = JSampler([5, 5], batch_size=B, seed=0)
    _, _, jblocks0 = jsampler.sample_blocks(jg, np.arange(B))
    cap_in = np.asarray(jblocks0[0].srcdata[JNID]).shape[0]
    all_ids = rng.permutation(N)

    m = tmesh("gp")
    g, labels, tranges, ttable, sampler, trng = cooperative_minibatch.setup(
        m, B, "cpu")
    same_array(labels, labels_np, "labels")
    same_array(tranges, ranges, "ranges")
    same_array(ttable, init.reshape(P, N // P, F), "table")
    sampler.sample_blocks(g, np.arange(B))
    same_array(trng.permutation(N), all_ids, "the seed order")
    seeds = all_ids[:B]
    _, _, jblocks = jsampler.sample_blocks(jg, seeds)
    _, _, blocks = sampler.sample_blocks(g, seeds)
    same_output(blocks, jblocks, "the first step's blocks")
    jmodel = JSAGE(F, 64, C, num_layers=2)
    params = {"model": jmodel.init(jax.random.PRNGKey(0), jblocks0,
                                   jnp.zeros((cap_in, F))),
              "table": table}
    ids = np.asarray(jblocks[0].srcdata[JNID])
    reqs = np.zeros((P, -(-cap_in // P)), np.int32)
    reqs.reshape(-1)[:cap_in] = ids
    jreqs = jax.device_put(jnp.asarray(reqs),
                           NamedSharding(mesh, PartitionSpec("gp")))
    jy = jnp.asarray(labels_np)[jblocks[-1].dstdata[JNID]]
    jm = jblocks[-1].dstdata["_mask"].astype(jnp.float32)

    def jloss(p):  # the script's own lines
        x = sparse_all_to_all_pull(mesh, ranges, p["table"], jreqs)
        x = x.reshape(-1, F)[:cap_in]
        ls = jce(jmodel.apply(p["model"], jblocks, x), jy)
        return (ls * jm).sum() / jnp.maximum(jm.sum(), 1)

    jl, jgrads = jvg(jloss)(params)
    model = cooperative_minibatch.Model(m, ttable, "cpu")
    state = {f"sage.{k}": v for k, v in dt.from_flax_params(
        jax.tree_util.tree_map(np.asarray, params["model"])).items()}
    model.load_state_dict({**state, "table": torch.from_numpy(init.reshape(
        P, N // P, F))})
    loss = cooperative_minibatch.step_loss(m, model, tranges, blocks, labels)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-4)
    want = {f"sage.{k}": v for k, v in dt.from_flax_params(
        jax.tree_util.tree_map(np.asarray, jgrads["model"])).items()}
    want["table"] = torch.from_numpy(np.asarray(jgrads["table"]))
    for k, p in model.named_parameters():
        r = want[k].numpy()
        np.testing.assert_allclose(p.grad.numpy(), r, rtol=1e-4,
                                   atol=1e-4 * np.abs(r).max(), err_msg=k)
    res = cooperative_minibatch.main(["--steps", "6"] + CPU)
    assert len(trains(res)) == 6
    assert "final loss" in capsys.readouterr().out
