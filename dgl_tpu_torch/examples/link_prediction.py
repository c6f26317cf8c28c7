"""Link prediction with negative sampling (counterpart of
``examples/link_prediction.py``; reference ``examples/core/link_pred``):
a GraphSAGE encoder, a dot-product scorer and the logistic loss, then an
AUC. The JAX script applies the encoder deterministically, so dropout is
off here too. ``python -m dgl_tpu_torch train --pipeline linkpred`` runs
:func:`train`.

Run: python -m dgl_tpu_torch.examples.link_prediction [--epochs 50]
"""
import numpy as np
import torch
import torch.nn.functional as F

from ..data import SyntheticDataset
from ..models import GraphSAGE
from ..sampling import global_uniform_negative_sampling
from ._common import generator, parse, parser


def load(device):
    """The 2,000-node synthetic graph, its features and its edges (the
    positive pairs)."""
    ds = SyntheticDataset(num_nodes=2000, num_edges=16000, num_classes=4,
                          feat_dim=32, device=device)
    g = ds[0]
    src, dst = g._relation(None).host_edges()
    pos_src = torch.from_numpy(src.astype(np.int64)).to(device)
    pos_dst = torch.from_numpy(dst.astype(np.int64)).to(device)
    return g, g.ndata["feat"], pos_src, pos_dst


def make_model(device, seed=0):
    """GraphSAGE 32-64-64, 2 layers, in eval mode (no dropout)."""
    return GraphSAGE(32, 64, 64, num_layers=2, generator=generator(seed),
                     device=device).eval()


def score(h, s, d):
    return (h[s] * h[d]).sum(-1)


def loss_fn(model, g, feat, ps, pd, ns, nd):
    h = model(g, feat)
    return (-F.logsigmoid(score(h, ps, pd)).mean()
            - F.logsigmoid(-score(h, ns, nd)).mean())


def train(epochs, device):
    """``epochs`` Adam steps (lr 1e-3), the negatives of epoch ``e`` drawn
    with seed ``e``; returns the model, the data and the losses."""
    g, feat, pos_src, pos_dst = load(device)
    model = make_model(device)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    losses = []
    for epoch in range(epochs):
        neg_src, neg_dst = global_uniform_negative_sampling(
            g, pos_src.shape[0], seed=epoch)
        k = min(neg_src.shape[0], pos_src.shape[0])
        loss = loss_fn(model, g, feat, pos_src[:k], pos_dst[:k],
                       neg_src[:k], neg_dst[:k])
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        losses.append(loss.item())
        if epoch % 10 == 0:
            print(f"epoch {epoch} loss {losses[-1]:.4f}")
    return model, (g, feat, pos_src, pos_dst), losses


def auc(model, g, feat, pos_src, pos_dst):
    """The AUC of the positive pairs against as many negatives (seed
    777)."""
    with torch.no_grad():
        h = model(g, feat)
        pos = score(h, pos_src, pos_dst).cpu().numpy()
        ns, nd = global_uniform_negative_sampling(g, pos_src.shape[0],
                                                  seed=777)
        neg = score(h, ns, nd).cpu().numpy()
    scores = np.concatenate([pos, neg])
    order = np.argsort(scores)
    ranks = np.empty_like(order, dtype=np.float64)
    ranks[order] = np.arange(1, len(scores) + 1)
    n_pos, n_neg = len(pos), len(neg)
    return float((ranks[:n_pos].sum() - n_pos * (n_pos + 1) / 2)
                 / (n_pos * n_neg))


def main(argv=None):
    p = parser(__doc__)
    p.add_argument("--epochs", type=int, default=50)
    args = parse(p, argv)
    model, data, losses = train(args.epochs, args.device)
    a = auc(model, *data)
    print(f"AUC {a:.4f}")
    return {"losses": losses, "auc": a}


if __name__ == "__main__":
    main()
