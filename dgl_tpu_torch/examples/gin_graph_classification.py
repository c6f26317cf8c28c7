"""Graph classification with GIN on MiniGC (counterpart of
``examples/gin_graph_classification.py``; reference
``examples/pytorch/gin/train.py``).

``GraphDataLoader`` pads every minibatch to one shape with ghost graphs,
as the JAX script's does for its single compiled step; the ghost graphs
are graphs of their own, left out of the loss and the accuracy by the
batch's graph mask, so they change no number. The step here runs
eagerly.

Run: python -m dgl_tpu_torch.examples.gin_graph_classification [--epochs 40]
"""
import time

import torch

from ..data import MiniGCDataset
from ..dataloading import GraphDataLoader
from ..models import GIN
from ._common import generator, masked_cross_entropy, parse, parser, sync


def loaders(num_graphs, batch_size, device):
    """The train set (``num_graphs`` graphs, seed 0) shuffled by seed 0,
    and the 80-graph test set (seed 1)."""
    train_ds = MiniGCDataset(num_graphs, 10, 20, seed=0, device=device)
    test_ds = MiniGCDataset(80, 10, 20, seed=1, device=device)
    loader = GraphDataLoader(train_ds, batch_size=batch_size, shuffle=True,
                             seed=0, device=device)
    test_loader = GraphDataLoader(test_ds, batch_size=batch_size,
                                  device=device)
    return train_ds, loader, test_loader


def node_features(bg):
    """The in-degree of every node, the model's one input feature."""
    return bg.in_degrees().float()[:, None]


def make_model(hidden, num_classes, device, seed=0):
    return GIN(1, hidden, num_classes, num_layers=3, dropout=0.0,
               generator=generator(seed), device=device)


def batch_loss(model, batch):
    bg, y, gmask = batch
    return masked_cross_entropy(model(bg, node_features(bg)), y, gmask)


def test_accuracy(model, test_loader):
    correct = total = 0
    model.eval()
    with torch.no_grad():
        for bg, y, gmask in test_loader:
            pred = model(bg, node_features(bg)).argmax(-1)
            correct += int(((pred == y) & gmask).sum())
            total += int(gmask.sum())
    model.train()
    return correct / total


def main(argv=None):
    p = parser(__doc__)
    p.add_argument("--epochs", type=int, default=40)
    p.add_argument("--num-graphs", type=int, default=320)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--hidden", type=int, default=32)
    p.add_argument("--lr", type=float, default=1e-2)
    args = parse(p, argv)

    train_ds, loader, test_loader = loaders(args.num_graphs,
                                            args.batch_size, args.device)
    model = make_model(args.hidden, train_ds.num_classes, args.device)
    opt = torch.optim.Adam(model.parameters(), lr=args.lr)

    epoch_losses, accs = [], []
    for epoch in range(args.epochs):
        t0 = time.time()
        tot = torch.zeros((), device=args.device)
        nb = 0
        for batch in loader:
            loss = batch_loss(model, batch)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            tot = tot + loss.detach()
            nb += 1
        epoch_losses.append(float(tot) / nb)
        if epoch % 10 == 0 or epoch == args.epochs - 1:
            accs.append(test_accuracy(model, test_loader))
            sync(args.device)
            print(f"epoch {epoch:3d} loss {epoch_losses[-1]:.4f} "
                  f"test acc {accs[-1]:.3f} "
                  f"({time.time() - t0:.2f}s/epoch)")
    return {"losses": epoch_losses, "test_accuracy": accs}


if __name__ == "__main__":
    main()
