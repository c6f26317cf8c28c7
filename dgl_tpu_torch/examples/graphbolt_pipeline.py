"""GraphBolt-style pipeline training (counterpart of
``examples/graphbolt_pipeline.py``; reference
``examples/graphbolt/node_classification.py``): ItemSampler ->
NeighborSamplerStage -> FeatureFetcher (a cached feature store) -> CopyTo
-> a GraphSAGE step, with the stage timers. The JAX script applies the
model deterministically, so dropout is off.

Run: python -m dgl_tpu_torch.examples.graphbolt_pipeline [--epochs 3]
"""
import time

import numpy as np
import torch

from .. import graphbolt as gb
from ..base import NID
from ..data import SyntheticDataset
from ..models import GraphSAGE
from ..profiler import StageTimer, timed_stage
from ._common import generator, masked_mean_loss, parse, parser


def load(cache: int, device):
    """The 20,000-node synthetic graph, its labels (host numpy), the
    training item set, and the feature store: the features behind an
    ``s3-fifo`` cache of ``cache`` rows."""
    ds = SyntheticDataset(num_nodes=20_000, num_edges=200_000,
                          num_classes=16, feat_dim=64, device=device)
    g = ds[0]
    labels = g.ndata["label"].cpu().numpy()
    train_ids = np.nonzero(g.ndata["train_mask"].cpu().numpy())[0]
    cached = gb.CachedFeature(gb.NumpyFeature(g.ndata["feat"].cpu().numpy()),
                              capacity=cache, policy="s3-fifo")
    store = gb.FeatureStore()
    store[("node", "_N", "feat")] = cached
    itemset = gb.ItemSet((train_ids, labels[train_ids]),
                         names=("seeds", "labels"))
    return ds, g, labels, itemset, store, cached


def pipeline(itemset, g, store, fanouts, batch_size, seed, device):
    """The epoch's datapipe, seeded with the epoch."""
    dp = gb.ItemSampler(itemset, batch_size, shuffle=True, seed=seed)
    dp = gb.NeighborSamplerStage(dp, g, fanouts, batch_size=batch_size,
                                 seed=seed, device=device)
    dp = gb.FeatureFetcher(dp, store, ["feat"])
    return gb.DataLoader(gb.CopyTo(dp, device))


def batch_inputs(mb, labels):
    """A minibatch's masked features, output labels and their mask."""
    blocks = mb.blocks
    x = torch.as_tensor(mb.node_features["feat"])
    x = x * blocks[0].srcdata["_mask"][:, None]
    out = blocks[-1].dstdata
    y = torch.from_numpy(labels).to(x.device)[out[NID]]
    return blocks, x, y, out["_mask"].float()


def make_model(num_classes, num_layers, device, seed=0):
    """GraphSAGE 64-128-``num_classes``, in eval mode (no dropout)."""
    return GraphSAGE(64, 128, num_classes, num_layers=num_layers,
                     generator=generator(seed), device=device).eval()


def main(argv=None):
    p = parser(__doc__)
    p.add_argument("--epochs", type=int, default=3)
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--fanouts", type=int, nargs="+", default=[10, 10])
    p.add_argument("--cache", type=int, default=4096)
    args = parse(p, argv)

    ds, g, labels, itemset, store, cached = load(args.cache, args.device)
    model = make_model(ds.num_classes, len(args.fanouts), args.device)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    timer = StageTimer()

    epoch_losses = []
    for epoch in range(args.epochs):
        loader = pipeline(itemset, g, store, args.fanouts, args.batch_size,
                          epoch, args.device)
        tot, nb = 0.0, 0
        t0 = time.perf_counter()
        for mb in timed_stage(timer, "pipeline", loader):
            with timer.stage("train"):
                blocks, x, y, ymask = batch_inputs(mb, labels)
                loss = masked_mean_loss(model(blocks, x), y, ymask)
                opt.zero_grad(set_to_none=True)
                loss.backward()
                opt.step()
                tot += loss.item()
                nb += 1
        epoch_losses.append(tot / nb)
        print(f"epoch {epoch} loss {tot / nb:.4f} "
              f"({time.perf_counter() - t0:.2f}s) "
              f"cache hit rate {cached.hit_rate:.2f}")
    print("stage timings:", timer.summary())
    return {"losses": epoch_losses, "hit_rate": cached.hit_rate}


if __name__ == "__main__":
    main()
