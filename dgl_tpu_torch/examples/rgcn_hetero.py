"""R-GCN entity classification on an ogbn-mag-shaped heterograph
(counterpart of ``examples/rgcn_hetero.py``; reference
``examples/pytorch/rgcn-hetero``).

Run: python -m dgl_tpu_torch.examples.rgcn_hetero [--epochs 80]
"""
import torch
from torch import nn

from ..data import SyntheticHeteroDataset
from ..nn import GraphConv, HeteroGraphConv
from ._common import generator, masked_cross_entropy, parse, parser


class HeteroRGCN(nn.Module):
    """Two ``HeteroGraphConv(aggregate="sum")`` layers of ``GraphConv``,
    one a relation, ReLU between them; the logits of every node type."""

    def __init__(self, in_feats, hidden, classes, etypes, *, generator=None,
                 device="cuda"):
        super().__init__()

        def layer(i, o):
            return HeteroGraphConv(
                {et: GraphConv(i, o, allow_zero_in_degree=True,
                               generator=generator, device=device)
                 for et in etypes}, aggregate="sum")

        self.layer0 = layer(in_feats, hidden)
        self.layer1 = layer(hidden, classes)

    def forward(self, g, inputs):
        h = {k: torch.relu(v) for k, v in self.layer0(g, inputs).items()}
        return self.layer1(g, h)


def load(device):
    """The dataset, its graph, the node features by type, and the paper
    labels, train mask and test mask."""
    ds = SyntheticHeteroDataset(device=device)
    g = ds[0]
    feats = {nt: g.nodes[nt].data["feat"] for nt in g.ntypes}
    paper = g.nodes["paper"].data
    return (ds, g, feats, paper["label"], paper["train_mask"].float(),
            paper["test_mask"].bool())


def make_model(g, num_classes, device, seed=0):
    """HeteroRGCN 64-32-``num_classes`` over ``g``'s edge types."""
    return HeteroRGCN(64, 32, num_classes, tuple(g.etypes),
                      generator=generator(seed), device=device)


def main(argv=None):
    p = parser(__doc__)
    p.add_argument("--epochs", type=int, default=80)
    args = parse(p, argv)

    ds, g, feats, labels, train_mask, test_mask = load(args.device)
    model = make_model(g, ds.num_classes, args.device)
    opt = torch.optim.Adam(model.parameters(), lr=1e-2)

    losses = []
    for epoch in range(args.epochs):
        out = model(g, feats)["paper"]
        loss = masked_cross_entropy(out, labels, train_mask)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        losses.append(loss.detach())
        if epoch % 20 == 0:
            print(f"epoch {epoch} loss {float(losses[-1]):.4f}")
    with torch.no_grad():
        pred = model(g, feats)["paper"].argmax(-1)
    acc = float((pred[test_mask] == labels[test_mask]).float().mean())
    print(f"test accuracy {acc:.4f}")
    return {"losses": torch.stack(losses).tolist(), "test_accuracy": acc}


if __name__ == "__main__":
    main()
