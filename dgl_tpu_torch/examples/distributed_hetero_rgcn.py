"""Partition-parallel heterogeneous R-GCN training (counterpart of
``examples/distributed_hetero_rgcn.py``): the per-etype halo exchange,
per-type weights, the parts' gradients summed.

One process holds ``--num-parts`` parts (default 8), or, under
``tools/launch.py``, each process holds one.

Run: python -m dgl_tpu_torch.examples.distributed_hetero_rgcn [--epochs 30]
"""
import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import distributed as dist
from ..data import synthetic_hetero_graph
from ._common import add_parts_argument, dist_mesh, parse, parser, total

AXIS = "gp"
F_IN, HIDDEN, CLASSES = 64, 32, 8


def setup(mesh, device):
    """The graph, the shards of its assignment into the mesh's parts, and
    the held parts' features by type, paper labels and train mask."""
    num_parts = mesh.shape[AXIS]
    g = synthetic_hetero_graph(device=device)
    assign = dist.hetero_partition_assignment(g, num_parts)
    shards = dist.build_hetero_shards(g, assign, num_parts)
    paper = g.nodes["paper"].data
    x = shards.shard_features({nt: g.nodes[nt].data["feat"]
                               for nt in g.ntypes})
    labels = shards.shard_features(
        {"paper": paper["label"].float()[:, None]})["paper"][..., 0]
    mask = shards.shard_features(
        {"paper": paper["train_mask"].float()[:, None]})["paper"][..., 0]
    x = {nt: mesh.local(v, AXIS) for nt, v in x.items()}
    return (g, shards, x, mesh.local(labels, AXIS).long(),
            mesh.local(mask, AXIS))


class Weights(nn.Module):
    """``w1`` and ``w2`` a node type, drawn as the JAX script draws them
    (numpy seed 0, normal times 0.1, every w1 then every w2)."""

    def __init__(self, ntypes, device):
        super().__init__()
        rng = np.random.default_rng(0)

        def draw(shape):
            return nn.Parameter(torch.from_numpy(
                (rng.normal(size=shape) * 0.1).astype(np.float32)))

        self.w1 = nn.ParameterDict({nt: draw((F_IN, HIDDEN))
                                    for nt in ntypes})
        self.w2 = nn.ParameterDict({nt: draw((HIDDEN, CLASSES))
                                    for nt in ntypes})
        self.to(device)


def part_losses(mesh, shards, w, x, labels, mask, count):
    """Each held part's share of the paper nodes' masked cross-entropy."""
    h1 = dist.dist_hetero_copy_u_sum(mesh, shards, x, mean=True, axis=AXIS)
    h1 = {nt: torch.relu(v @ w.w1[nt] + x[nt] @ w.w1[nt])
          for nt, v in h1.items()}
    h2 = dist.dist_hetero_copy_u_sum(mesh, shards, h1, mean=True, axis=AXIS)
    logits = h2["paper"] @ w.w2["paper"]
    ls = F.cross_entropy(logits.reshape(-1, CLASSES), labels.reshape(-1),
                         reduction="none").reshape(labels.shape)
    return (ls * mask).sum(1) / max(count, 1)


def main(argv=None):
    p = parser(__doc__)
    p.add_argument("--epochs", type=int, default=30)
    add_parts_argument(p)
    args = parse(p, argv)

    mesh = dist_mesh(args.num_parts, AXIS, args.device)
    g, shards, x, labels, mask = setup(mesh, args.device)
    print("hetero shards:",
          {nt: shards.n_max[nt] for nt in shards.ntypes},
          "halo caps:", {nt: shards.h_max[nt] for nt in shards.ntypes})
    count = int(g.nodes["paper"].data["train_mask"].sum())
    w = Weights(g.ntypes, args.device)
    opt = torch.optim.Adam(w.parameters(), lr=1e-2)

    losses = []
    for epoch in range(args.epochs):
        lp = part_losses(mesh, shards, w, x, labels, mask, count)
        opt.zero_grad(set_to_none=True)
        lp.sum().backward()
        mesh.sum_grads(list(w.parameters()), AXIS)
        opt.step()
        losses.append(float(total(mesh, lp, AXIS)))
        if epoch % 10 == 0:
            print(f"epoch {epoch} loss {losses[-1]:.4f}")
    print(f"final loss {losses[-1]:.4f}")
    return {"losses": losses}


if __name__ == "__main__":
    main()
