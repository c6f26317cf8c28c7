"""Full-graph GCN on a Reddit-scale graph through the bitmap SpMM
(counterpart of ``examples/reddit_fullgraph_gcn.py``).

The high-degree fast path (``ops/bitmap_spmm.py``): at Reddit's density
(average degree about 490) the adjacency streams as a packed bitmap
through the bitmap SpMM kernel, whose cost scales with N^2, not E, and
does not depend on the degrees' skew. ``RedditDataset()`` is the
synthetic stand-in unless ``raw_dir`` holds the real files. On the card
the bitmap plan is forced (2 kernel launches a forward, 4 a step); on
the CPU (``--device cpu``) the graph carries no plan.

Run: python -m dgl_tpu_torch.examples.reddit_fullgraph_gcn
"""
import torch
from torch import nn

from .. import add_self_loop, remove_self_loop, to_simple
from ..data import RedditDataset
from ..nn import GraphConv
from ._common import generator, masked_cross_entropy, parse, parser

PLANS = dict(num_hubs=256, bitmap=True, bitmap_max_bytes=8 << 30)


def recipe_graph(g, plans=None):
    """``to_simple`` (the bitmap holds one bit per (src, dst)), the
    self-loops, and the forced bitmap plan when ``plans`` (default: when
    ``g`` is on a card). Returns the graph without and with the plan."""
    g0 = add_self_loop(remove_self_loop(to_simple(g)))
    if plans is None:
        plans = g0.device.type == "cuda"
    if not plans:
        return g0, g0
    g = g0.with_spmm_plans(**PLANS)
    assert g._relation(None).bitmap_plan is not None, "density too low?"
    return g0, g


class GCN(nn.Module):
    """GraphConv in -> 16 (ReLU) -> GraphConv 16 -> classes."""

    def __init__(self, in_feats, num_classes, *, generator=None,
                 device="cuda"):
        super().__init__()
        self.conv0 = GraphConv(in_feats, 16, activation=torch.relu,
                               allow_zero_in_degree=True,
                               generator=generator, device=device)
        self.conv1 = GraphConv(16, num_classes, allow_zero_in_degree=True,
                               generator=generator, device=device)

    def forward(self, g, x):
        return self.conv1(g, self.conv0(g, x))


def make_model(in_feats, num_classes, device, seed=0):
    return GCN(in_feats, num_classes, generator=generator(seed),
               device=device)


def main(argv=None):
    args = parse(parser(__doc__), argv)

    ds = RedditDataset(device=args.device)
    g0, g = recipe_graph(ds[0])
    feat = g0.ndata["feat"]
    labels = g0.ndata["label"]
    train_mask = g0.ndata["train_mask"].float()

    model = make_model(feat.shape[1], ds.num_classes, args.device)
    opt = torch.optim.Adam(model.parameters(), lr=1e-2)

    losses = []
    for epoch in range(30):
        loss = masked_cross_entropy(model(g, feat), labels, train_mask)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        losses.append(loss.detach())
        if epoch % 10 == 0:
            print(f"epoch {epoch}: loss {float(losses[-1]):.4f}")
    with torch.no_grad():
        logits = model(g, feat)
    test = g0.ndata["test_mask"].cpu().numpy().astype(bool)
    acc = float((logits.argmax(-1).cpu().numpy()
                 == labels.cpu().numpy())[test].mean())
    print(f"test acc {acc:.3f}")
    return {"losses": torch.stack(losses).tolist(), "test_accuracy": acc}


if __name__ == "__main__":
    main()
