"""Full-graph GAT through the bitmap GAT kernels (counterpart of
``examples/fullgraph_gat_bitmap.py``).

With a bitmap plan attached, ``GATConv`` routes through the
flash-style kernels instead of per-edge attention: rank-1 logits
(``el[s] + er[d]``), each destination row's in-edges walked from the
relation's CSC, an online softmax and the aggregation in one pass; the
backward walks the CSC and the CSR. On the card that is one forward
kernel launch a layer and, in a step, one launch of each backward
kernel a layer (2 each for this two-layer GAT).

At Cora's size ``with_spmm_plans`` also attaches the dense attention
mask, which ``GATConv`` takes before the bitmap; the port leaves it out
(``dense_attn=False``) so that the bitmap route this example shows is
the one that runs. On the CPU (``--device cpu``) no plan is attached.

Run: python -m dgl_tpu_torch.examples.fullgraph_gat_bitmap
"""
import torch
import torch.nn.functional as F
from torch import nn

from .. import add_self_loop, remove_self_loop, to_simple
from ..data import CoraGraphDataset
from ..nn import GATConv
from ._common import generator, masked_cross_entropy, parse, parser


class GAT(nn.Module):
    """GATConv in -> ``hidden`` x ``heads``, ELU, GATConv -> classes (one
    head)."""

    def __init__(self, in_feats, num_classes, heads=8, hidden=8, *,
                 generator=None, device="cuda"):
        super().__init__()
        self.conv0 = GATConv(in_feats, hidden, heads,
                             allow_zero_in_degree=True, generator=generator,
                             device=device)
        self.conv1 = GATConv(heads * hidden, num_classes, 1,
                             allow_zero_in_degree=True, generator=generator,
                             device=device)

    def forward(self, g, x):
        h = self.conv0(g, x)
        h = F.elu(h.reshape(h.shape[0], -1))
        h = self.conv1(g, h)
        return h.reshape(h.shape[0], -1)


def recipe_graph(g, plans=None):
    """``to_simple``, the self-loops, and the bitmap plan when ``plans``
    (default: when ``g`` is on a card)."""
    g = add_self_loop(remove_self_loop(to_simple(g)))
    if plans is None:
        plans = g.device.type == "cuda"
    if plans:
        g = g.with_spmm_plans(bitmap=True, dense_attn=False)
        assert g._relation(None).bitmap_plan is not None
    return g


def make_model(in_feats, num_classes, device, seed=0):
    return GAT(in_feats, num_classes, generator=generator(seed),
               device=device)


def make_optimizer(model):
    """optax.adamw(5e-3, weight_decay=5e-4)."""
    return torch.optim.AdamW(model.parameters(), lr=5e-3, weight_decay=5e-4)


def main(argv=None):
    args = parse(parser(__doc__), argv)

    ds = CoraGraphDataset(device=args.device)
    g = recipe_graph(ds[0])
    feat = g.ndata["feat"]
    labels = g.ndata["label"]
    tr = g.ndata["train_mask"].float()
    te = g.ndata["test_mask"].float()

    model = make_model(feat.shape[1], ds.num_classes, args.device)
    opt = make_optimizer(model)

    losses, accs = [], []
    for epoch in range(30):
        loss = masked_cross_entropy(model(g, feat), labels, tr)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        losses.append(loss.detach())
        if epoch % 10 == 9:
            with torch.no_grad():
                pred = (model(g, feat).argmax(-1) == labels).float()
            accs.append(float((pred * te).sum() / te.sum()))
            print(f"epoch {epoch + 1}: loss {float(losses[-1]):.4f} "
                  f"test acc {accs[-1]:.4f}")
    return {"losses": torch.stack(losses).tolist(), "test_accuracy": accs}


if __name__ == "__main__":
    main()
