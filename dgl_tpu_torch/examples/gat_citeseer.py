"""Full-graph GAT on Citeseer (counterpart of ``examples/gat_citeseer.py``;
reference ``examples/core/gat/train.py``: the SDDMM + edge-softmax
attention path).

On the card the graph carries ``with_spmm_plans(weighted=True)``; at
Citeseer's size the dense attention mask attaches with it and
``GATConv`` runs its dense route (no hand-written kernel). On the CPU
(``--device cpu``) no plan is attached.

Run: python -m dgl_tpu_torch.examples.gat_citeseer [--epochs 200]
"""
import time

import torch

from .. import add_self_loop, remove_self_loop
from ..data import CiteseerGraphDataset
from ..models import GAT
from ._common import (generator, masked_cross_entropy, parse, parser,
                      seed_dropout, sync)


def recipe_graph(g, plans=None):
    """``add_self_loop(remove_self_loop(g))``, with the weighted plans when
    ``plans`` (default: when ``g`` is on a card)."""
    g = add_self_loop(remove_self_loop(g))
    if plans is None:
        plans = g.device.type == "cuda"
    if plans:
        g = g.with_spmm_plans(weighted=True)
    return g


def make_model(in_feats, num_classes, device, seed=0):
    """GAT ``in_feats``-8x8-``num_classes``, feature and attention
    dropout 0.6."""
    return GAT(in_feats, 8, num_classes, heads=8, generator=generator(seed),
               device=device)


def main(argv=None):
    p = parser(__doc__)
    p.add_argument("--epochs", type=int, default=200)
    args = parse(p, argv)

    ds = CiteseerGraphDataset(device=args.device)
    g = recipe_graph(ds[0])
    feat = g.ndata["feat"]
    labels = g.ndata["label"]
    train_mask = g.ndata["train_mask"].float()
    test_mask = g.ndata["test_mask"].float()

    model = make_model(feat.shape[1], ds.num_classes, args.device)
    opt = torch.optim.Adam(model.parameters(), lr=5e-3)
    seed_dropout(1)

    t0 = time.perf_counter()
    losses = []
    model.train()
    for epoch in range(args.epochs):
        loss = masked_cross_entropy(model(g, feat), labels, train_mask)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        losses.append(loss.detach())
        if epoch % 40 == 0:
            print(f"epoch {epoch:3d} loss {float(losses[-1]):.4f}")
    model.eval()
    with torch.no_grad():
        pred = model(g, feat).argmax(-1)
    acc = float(((pred == labels).float() * test_mask).sum()
                / test_mask.sum())
    sync(args.device)
    print(f"train time {time.perf_counter() - t0:.3f}s  "
          f"test accuracy {acc:.4f}")
    return {"losses": torch.stack(losses).tolist(), "test_accuracy": acc}


if __name__ == "__main__":
    main()
