"""The port's minibatch example programs (``graphsage_minibatch``,
``sage_device_sampler``, ``graphbolt_pipeline``) against the JAX
package's scripts.

The data (graph, features, labels, training ids) equals the JAX script's
exactly; the host samplers draw the same blocks from the same seeds (the
reference's native library is loaded first: without it the reference
picks in numpy and draws others), so the first batch of the first epoch,
its blocks, gathered features, labels and masks, is equal too. The first
step's loss and every gradient agree within rtol = 1e-4, atol = 1e-4 *
max|ref| with the JAX script's flax parameters carried over by
``from_flax_params``. The on-device sampler draws from torch's generator,
not JAX's: its first MFG is handed to the reference as its own
``DeviceMFG``. Then ``main([..., "--device", "cpu"])`` runs end to end
at a few epochs (larger batches than the default, for time), its losses
finite and falling (``sage_device_sampler`` over Pubmed's first 16
features, its inference in batches of 128 seeds: over all 500 the
inference gathers 26 GB of rows).
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import dgl_tpu as jdgl
import dgl_tpu.data as J
from dgl_tpu import dataloading as jdl
from dgl_tpu import graphbolt as jgb
from dgl_tpu.base import NID as JNID
import dgl_tpu_torch as dt
from dgl_tpu_torch.examples import (graphbolt_pipeline, graphsage_minibatch,
                                    sage_device_sampler)

from test_torch_data import same_array, same_graph
from test_torch_examples_fullgraph import (CPU, _download_dir, _one_thread,
                                           held_step, jvg, load_flax, trains)
from test_torch_graph_utils import same_graph as same_block
from test_torch_sampling import reference_native

__all__ = ["_download_dir", "_one_thread"]  # module fixtures, used here too


@pytest.fixture(autouse=True, scope="module")
def _reference_native():
    reference_native()


def jmasked_mean(logits, y, m):
    ls = optax.softmax_cross_entropy_with_integer_labels(logits, y)
    return (ls * m).sum() / jnp.maximum(m.sum(), 1)


def same_blocks(got, ref, what):
    assert len(got) == len(ref), what
    for i, (a, b) in enumerate(zip(got, ref)):
        same_block(a, b, f"{what}: block {i}", batch=False)


def first_step(jmodel, jblocks, jx, jy, jm, model, blocks, x, y, m):
    params = jmodel.init(jax.random.PRNGKey(0), jblocks, jx)
    jloss, jgrads = jvg(lambda p: jmasked_mean(jmodel.apply(p, jblocks, jx),
                                               jy, jm))(params)
    load_flax(model, params)
    loss = graphsage_minibatch.loss_fn(model, blocks, x, y, m)
    loss.backward()
    held_step(loss, model, jloss, jgrads)


def test_graphsage_minibatch_data_first_step_and_main(capsys):
    from dgl_tpu.models import GraphSAGE as JSAGE

    jds = J.SyntheticDataset(num_nodes=20_000, num_edges=200_000,
                             num_classes=16, feat_dim=64)
    jg = jds[0]
    jtrain = np.nonzero(np.asarray(jg.ndata["train_mask"]))[0]
    ds, g, feats, labels, train_ids = graphsage_minibatch.load("cpu")
    same_graph(g, jg, "graphsage_minibatch's graph")
    same_array(train_ids, jtrain, "training ids")
    jsampler = jdl.FixedShapeNeighborSampler([10, 10], batch_size=256,
                                             seed=0)
    jsampler.sample_blocks(jg, jtrain[:256])
    sampler = dt.dataloading.FixedShapeNeighborSampler(
        [10, 10], batch_size=256, seed=0, device="cpu")
    sampler.sample_blocks(g, train_ids[:256])
    _, _, jblocks = next(iter(jdl.DataLoader(jg, jtrain, jsampler,
                                             batch_size=256, shuffle=True,
                                             seed=0)))
    _, _, blocks = next(iter(dt.dataloading.DataLoader(
        g, train_ids, sampler, batch_size=256, shuffle=True, seed=0,
        device="cpu")))
    same_blocks(blocks, jblocks, "the first batch")
    jf, jl = jg.ndata["feat"], jg.ndata["label"].astype(jnp.int32)
    jx = jf[jblocks[0].srcdata[JNID]] * jblocks[0].srcdata["_mask"][:, None]
    jy = jl[jblocks[-1].dstdata[JNID]]
    jm = jblocks[-1].dstdata["_mask"].astype(jnp.float32)
    x, y, m = graphsage_minibatch.batch_inputs(blocks, feats, labels)
    for a, b, what in ((x, jx, "features"), (y, jy, "labels"),
                       (m, jm, "mask")):
        same_array(a, b, what)
    first_step(JSAGE(64, 128, 16, num_layers=2), jblocks, jx, jy, jm,
               graphsage_minibatch.make_model(16, 2, "cpu"), blocks, x, y, m)
    res = graphsage_minibatch.main(["--epochs", "2", "--batch-size", "1024"]
                                   + CPU)
    assert len(trains(res)) == 2
    assert "epoch 1 loss" in capsys.readouterr().out


def test_graphbolt_pipeline_data_first_step_and_main(capsys):
    from dgl_tpu.models import GraphSAGE as JSAGE

    jg = J.SyntheticDataset(num_nodes=20_000, num_edges=200_000,
                            num_classes=16, feat_dim=64)[0]
    jlabels = np.asarray(jg.ndata["label"])
    jtrain = np.nonzero(np.asarray(jg.ndata["train_mask"]))[0]
    jstore = jgb.FeatureStore()
    jstore[("node", "_N", "feat")] = jgb.CachedFeature(
        jgb.NumpyFeature(np.asarray(jg.ndata["feat"])), capacity=4096,
        policy="s3-fifo")
    dp = jgb.ItemSampler(jgb.ItemSet((jtrain, jlabels[jtrain]),
                                     names=("seeds", "labels")), 256,
                         shuffle=True, seed=0)
    dp = jgb.NeighborSamplerStage(dp, jg, [10, 10], batch_size=256, seed=0)
    jmb = next(iter(jgb.DataLoader(jgb.CopyTo(jgb.FeatureFetcher(
        dp, jstore, ["feat"])))))

    ds, g, labels, itemset, store, cached = graphbolt_pipeline.load(4096,
                                                                    "cpu")
    same_graph(g, jg, "graphbolt_pipeline's graph")
    same_array(labels, jlabels, "labels")
    mb = next(iter(graphbolt_pipeline.pipeline(itemset, g, store, [10, 10],
                                               256, 0, "cpu")))
    blocks, x, y, m = graphbolt_pipeline.batch_inputs(mb, labels)
    jblocks = jmb.blocks
    same_blocks(blocks, jblocks, "the first minibatch")
    jx = (jnp.asarray(jmb.node_features["feat"])
          * jblocks[0].srcdata["_mask"][:, None])
    jy = jnp.asarray(jlabels)[jblocks[-1].dstdata[JNID]]
    jm = jblocks[-1].dstdata["_mask"].astype(jnp.float32)
    for a, b, what in ((x, jx, "features"), (y, jy, "labels"),
                       (m, jm, "mask")):
        same_array(a, b, what)
    first_step(JSAGE(64, 128, 16, num_layers=2), jblocks, jx, jy, jm,
               graphbolt_pipeline.make_model(16, 2, "cpu"), blocks, x, y, m)
    res = graphbolt_pipeline.main(["--epochs", "2", "--batch-size", "1024"]
                                  + CPU)
    assert len(trains(res)) == 2
    out = capsys.readouterr().out
    assert "cache hit rate" in out and "stage timings:" in out


def test_sage_device_sampler_data_first_step_and_main(capsys, monkeypatch):
    from dgl_tpu.models import DeviceSAGE as JDeviceSAGE
    from dgl_tpu.sampling.device_sampler import DeviceMFG as JMFG

    jds = J.PubmedGraphDataset()
    jg = jdgl.add_self_loop(jdgl.remove_self_loop(jds[0]))
    rel = jg._relation(None)
    (ds, g, feats, labels, train_mask, test_mask, indptr,
     indices) = sage_device_sampler.load("cpu")
    same_graph(g, jg, "sage_device_sampler's graph")
    same_array(indptr, np.asarray(rel.csc_indptr.astype(jnp.int32)),
               "indptr")
    same_array(indices, np.asarray(rel.csc_indices.astype(jnp.int32)),
               "indices")
    gen = torch.Generator().manual_seed(0)
    ids, mask = dt.sampling.device_seed_batches(gen, g.num_nodes(), 256,
                                                train_mask, device="cpu")
    # the first batch with a training seed, so that the loss is not 0
    i = int(torch.nonzero(mask.any(1))[0])
    seeds, smask = ids[i], mask[i]
    mfg = dt.sampling.DeviceNeighborSampler([10, 10]).sample(
        gen, indptr, indices, seeds, seed_mask=smask)
    jmfg = JMFG(*[[jnp.asarray(t.numpy()) for t in part]
                  for part in (mfg.frontiers, mfg.nbrs, mfg.masks)],
                jnp.asarray(mfg.seed_mask.numpy()))
    jfeats = jg.ndata["feat"]
    jx = jfeats[jmfg.input_nodes()]
    jy = jg.ndata["label"].astype(jnp.int32)[jnp.asarray(seeds.numpy())]
    jw = jnp.asarray(smask.numpy()).astype(jnp.float32)
    jmodel = JDeviceSAGE(jfeats.shape[1], 64, jds.num_classes, num_layers=2)
    params = jmodel.init(jax.random.PRNGKey(1), jmfg, jx)
    jloss, jgrads = jvg(lambda p: jmasked_mean(jmodel.apply(p, jmfg, jx),
                                               jy, jw))(params)
    model = load_flax(sage_device_sampler.make_model(
        feats.shape[1], ds.num_classes, "cpu"), params)
    from dgl_tpu_torch.examples._common import masked_mean_loss

    loss = masked_mean_loss(model(mfg, feats[mfg.input_nodes()]),
                            labels[seeds], smask)
    loss.backward()
    held_step(loss, model, jloss, jgrads)
    # Pubmed's first 16 features and inference batches of 128 seeds: the
    # inference over every node at fanouts [25, 25] gathers 26 GB of the
    # 500-wide rows, too much for a test on the host
    load = sage_device_sampler.load

    def narrow(device):
        out = list(load(device))
        out[2] = out[2][:, :16].contiguous()
        return tuple(out)

    monkeypatch.setattr(sage_device_sampler, "load", narrow)
    monkeypatch.setattr(sage_device_sampler, "INFER_BATCH", 128)
    res = sage_device_sampler.main(["--epochs", "2", "--batch-size", "1024",
                                    "--cpu"])
    assert len(trains(res)) == 2
    assert 0.0 <= res["test_accuracy"] <= 1.0
    assert "test accuracy:" in capsys.readouterr().out
