"""Full-graph GCN on Cora (counterpart of ``examples/gcn_cora.py``;
reference ``examples/core/gcn/train.py``).

On the card the graph carries ``with_spmm_plans(weighted=True)``: at
Cora's density the bitmap plan attaches, and each GraphConv's aggregation
runs through the bitmap SpMM kernel (2 launches a forward, 4 a training
step). On the CPU (``--device cpu``) no plan is attached, as the JAX
script keeps the sorted-segment path there.

Run: python -m dgl_tpu_torch.examples.gcn_cora [--epochs 200]
"""
import time

import torch

from .. import add_self_loop, remove_self_loop
from ..data import CoraGraphDataset
from ..models import GCN
from ._common import (generator, masked_cross_entropy, parse, parser,
                      seed_dropout, sync)


def recipe_graph(g, plans=None):
    """``add_self_loop(remove_self_loop(g))``, with the weighted SpMM plans
    when ``plans`` (default: when ``g`` is on a card)."""
    g = add_self_loop(remove_self_loop(g))
    if plans is None:
        plans = g.device.type == "cuda"
    if plans:
        g = g.with_spmm_plans(weighted=True)
    return g


def make_model(in_feats, hidden, num_classes, device, seed=0):
    """GCN ``in_feats``-``hidden``-``num_classes``, dropout 0.5, weights
    drawn from ``seed``."""
    return GCN(in_feats, hidden, num_classes, generator=generator(seed),
               device=device)


def train_step(model, opt, g, feat, labels, train_mask):
    """One Adam step of the masked cross-entropy; the loss (on the
    device)."""
    model.train()
    loss = masked_cross_entropy(model(g, feat), labels, train_mask)
    opt.zero_grad(set_to_none=True)
    loss.backward()
    opt.step()
    return loss.detach()


def accuracy(model, g, feat, labels, masks):
    """The accuracy over each of ``masks``, dropout off."""
    model.eval()
    with torch.no_grad():
        correct = (model(g, feat).argmax(-1) == labels).float()
    model.train()
    return [float((correct * m).sum() / m.sum()) for m in masks]


def main(argv=None):
    p = parser(__doc__)
    p.add_argument("--epochs", type=int, default=200)
    p.add_argument("--lr", type=float, default=1e-2)
    p.add_argument("--hidden", type=int, default=16)
    args = parse(p, argv)

    ds = CoraGraphDataset(device=args.device)
    g = recipe_graph(ds[0])
    feat = g.ndata["feat"]
    labels = g.ndata["label"]
    train_mask = g.ndata["train_mask"].float()
    val_mask = g.ndata["val_mask"].float()
    test_mask = g.ndata["test_mask"].float()

    model = make_model(feat.shape[1], args.hidden, ds.num_classes,
                       args.device)
    # optax.adam(lr, b1=0.9): torch's betas (0.9, 0.999) and eps 1e-8
    opt = torch.optim.Adam(model.parameters(), lr=args.lr)
    seed_dropout(1)

    t0 = time.perf_counter()
    losses = []
    for epoch in range(args.epochs):
        losses.append(train_step(model, opt, g, feat, labels, train_mask))
        if epoch % 20 == 0:
            val_acc, = accuracy(model, g, feat, labels, [val_mask])
            print(f"epoch {epoch:3d} loss {float(losses[-1]):.4f} "
                  f"val {val_acc:.4f}")
    sync(args.device)
    train_time = time.perf_counter() - t0
    test_acc, = accuracy(model, g, feat, labels, [test_mask])
    print(f"train time {train_time:.3f}s  test accuracy {test_acc:.4f}")
    return {"losses": torch.stack(losses).tolist(), "train_time": train_time,
            "test_accuracy": test_acc}


if __name__ == "__main__":
    main()
