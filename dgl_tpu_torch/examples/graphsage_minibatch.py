"""Minibatch GraphSAGE over the fixed-shape neighbour sampler (counterpart
of ``examples/graphsage_minibatch.py``; reference
``examples/graphbolt/node_classification.py``).

The host sampler hands every batch the same shapes (padding slots masked
by ``_mask``), which the JAX script relies on to compile its step once;
the padding is kept here because the masked padding rows are part of the
batch the loss sees. The step runs eagerly. The JAX script applies the
model deterministically, so dropout is off.

Run: python -m dgl_tpu_torch.examples.graphsage_minibatch [--epochs 5]
"""
import time

import numpy as np
import torch

from .. import dataloading
from ..base import NID
from ..data import SyntheticDataset
from ..models import GraphSAGE
from ._common import generator, masked_mean_loss, parse, parser, sync


def load(device):
    """The 20,000-node synthetic graph, its features, labels and training
    ids."""
    ds = SyntheticDataset(num_nodes=20_000, num_edges=200_000,
                          num_classes=16, feat_dim=64, device=device)
    g = ds[0]
    train_ids = np.nonzero(g.ndata["train_mask"].cpu().numpy())[0]
    return ds, g, g.ndata["feat"], g.ndata["label"], train_ids


def make_model(num_classes, num_layers, device, seed=0):
    """GraphSAGE 64-128-``num_classes``, in eval mode (no dropout)."""
    return GraphSAGE(64, 128, num_classes, num_layers=num_layers,
                     generator=generator(seed), device=device).eval()


def batch_inputs(blocks, feats, labels):
    """A batch's masked input features, its output labels and their
    mask."""
    x = feats[blocks[0].srcdata[NID]] * blocks[0].srcdata["_mask"][:, None]
    y = labels[blocks[-1].dstdata[NID]]
    return x, y, blocks[-1].dstdata["_mask"].float()


def loss_fn(model, blocks, x, y, ymask):
    return masked_mean_loss(model(blocks, x), y, ymask)


def main(argv=None):
    p = parser(__doc__)
    p.add_argument("--epochs", type=int, default=5)
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--fanouts", type=int, nargs="+", default=[10, 10])
    args = parse(p, argv)

    ds, g, feats, labels, train_ids = load(args.device)
    sampler = dataloading.FixedShapeNeighborSampler(
        args.fanouts, batch_size=args.batch_size, seed=0, device=args.device)
    # the JAX script samples one batch to initialise its model: the same
    # draw here keeps the sampler's later batches the same
    sampler.sample_blocks(g, train_ids[: args.batch_size])
    model = make_model(ds.num_classes, len(args.fanouts), args.device)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)

    epoch_losses = []
    for epoch in range(args.epochs):
        loader = dataloading.DataLoader(
            g, train_ids, sampler, batch_size=args.batch_size,
            shuffle=True, seed=epoch, device=args.device)
        t0 = time.perf_counter()
        tot = torch.zeros((), device=args.device)
        nb = 0
        for _, _, blocks in loader:
            loss = loss_fn(model, blocks,
                           *batch_inputs(blocks, feats, labels))
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            tot = tot + loss.detach()
            nb += 1
        epoch_losses.append(float(tot) / nb)
        sync(args.device)
        print(f"epoch {epoch} loss {epoch_losses[-1]:.4f} "
              f"({time.perf_counter() - t0:.2f}s, {nb} batches)")
    return {"losses": epoch_losses}


if __name__ == "__main__":
    main()
