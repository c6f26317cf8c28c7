"""Partition-parallel full-graph training over a mesh of parts
(counterpart of ``examples/distributed_sage.py``; reference
``examples/distributed/graphsage/node_classification.py``): multilevel
shards, halo-exchange SpMM, the parts' gradients summed.

The JAX script runs on however many devices are visible. Here one
process holds ``--num-parts`` parts (default 8) on one device, or, under
``tools/launch.py``, each process holds one part (after
``distributed.initialize()``). The JAX script's one compiled step is an
eager step.

Run: python -m dgl_tpu_torch.examples.distributed_sage [--epochs 20]
"""
import time

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import distributed as dist
from ..data import SyntheticDataset
from ._common import (add_parts_argument, dist_mesh, parse, parser, sync,
                      total)

AXIS = "gp"
F_IN, HIDDEN, CLASSES = 64, 64, 8


def setup(mesh, device):
    """The graph, its multilevel assignment into the mesh's parts, the
    shards and their tables, and the parts' features, labels and train
    mask held here."""
    num_parts = mesh.shape[AXIS]
    ds = SyntheticDataset(num_nodes=4096, num_edges=40_000, num_classes=8,
                          feat_dim=64, device=device)
    g = ds[0]
    parts = dist.metis_partition_assignment(g, num_parts)
    shards = dist.build_shards(g, parts, num_parts)
    tables = dist.shard_arrays(mesh, shards, axis=AXIS)
    x = shards.shard_features(g.ndata["feat"])
    y = shards.shard_features(g.ndata["label"].float()[:, None])[..., 0]
    m = shards.shard_features(g.ndata["train_mask"].float()[:, None])[..., 0]
    return (g, parts, shards, tables, mesh.local(x, AXIS),
            mesh.local(y, AXIS).long(), mesh.local(m, AXIS))


class Weights(nn.Module):
    """The two weight matrices, drawn as the JAX script draws them (numpy
    seed 0, normal times 0.1)."""

    def __init__(self, device):
        super().__init__()
        rng = np.random.default_rng(0)
        self.w1 = nn.Parameter(torch.from_numpy(
            (rng.normal(size=(F_IN, HIDDEN)) * 0.1).astype(np.float32)))
        self.w2 = nn.Parameter(torch.from_numpy(
            (rng.normal(size=(HIDDEN, CLASSES)) * 0.1).astype(np.float32)))
        self.to(device)


def part_losses(mesh, shards, tables, w, x, y, m, count):
    """Each held part's share of the masked mean cross-entropy (their sum
    over every part is the loss)."""
    h = dist.dist_copy_u_sum(mesh, shards, x, tables=tables, mean=True,
                             axis=AXIS)
    h = torch.relu(h @ w.w1)
    h = dist.dist_copy_u_sum(mesh, shards, h, tables=tables, mean=True,
                             axis=AXIS)
    logits = h @ w.w2
    ls = F.cross_entropy(logits.reshape(-1, CLASSES), y.reshape(-1),
                         reduction="none").reshape(y.shape)
    return (ls * m).sum(1) / max(count, 1)


def main(argv=None):
    p = parser(__doc__)
    p.add_argument("--epochs", type=int, default=20)
    add_parts_argument(p)
    args = parse(p, argv)

    mesh = dist_mesh(args.num_parts, AXIS, args.device)
    n_dev = mesh.shape[AXIS]
    print(f"mesh: {n_dev} devices over axis '{AXIS}'")
    g, parts, shards, tables, x, y, m = setup(mesh, args.device)
    print(f"shards: n_max={shards.n_max} e_max={shards.e_max} "
          f"h_max={shards.h_max} "
          f"edge_cut={dist.edge_cut(g, parts)}")
    count = int(g.ndata["train_mask"].sum())
    w = Weights(args.device)
    opt = torch.optim.Adam(w.parameters(), lr=1e-2)

    losses = []
    for epoch in range(args.epochs):
        t0 = time.perf_counter()
        lp = part_losses(mesh, shards, tables, w, x, y, m, count)
        opt.zero_grad(set_to_none=True)
        lp.sum().backward()
        mesh.sum_grads(list(w.parameters()), AXIS)
        opt.step()
        losses.append(float(total(mesh, lp, AXIS)))
        sync(args.device)
        print(f"epoch {epoch} loss {losses[-1]:.4f} "
              f"({time.perf_counter() - t0:.3f}s)")
    return {"losses": losses}


if __name__ == "__main__":
    main()
