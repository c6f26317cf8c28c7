"""Distributed link prediction: the DistDGL edge-dataloader workflow over
a mesh of parts (counterpart of
``examples/distributed_link_prediction.py``; reference
``examples/distributed/graphsage``'s link-prediction mode).

Every part samples blocks for its own edge split's endpoints and uniform
negatives (``DistEdgeDataLoader``), the features are pulled from the
row-sharded table with one ``sparse_all_to_all_pull``, and a dot-product
decoder scores the (src, dst) pairs gathered from each part's
embeddings. Each held part runs in turn, eagerly; dropout is off, as the
JAX script applies the model deterministically.

One process holds ``--num-parts`` parts (default 8), or, under
``tools/launch.py``, each process holds one.

Run: python -m dgl_tpu_torch.examples.distributed_link_prediction [--epochs 3]
"""
import time

import numpy as np
import torch
import torch.nn.functional as F

from .. import distributed as dist
from ..data import SyntheticDataset
from ..models import GraphSAGE
from ._common import (add_parts_argument, dist_mesh, generator, parse,
                      parser, parts_here, total)

AXIS = "dp"


def setup(mesh, batch_size, fanouts, num_negatives, device):
    """The graph, its part-major CSC over the multilevel assignment, the
    row-sharded feature table and the loader over every fourth edge."""
    num_parts = mesh.shape[AXIS]
    ds = SyntheticDataset(num_nodes=2048, num_edges=20_000, num_classes=4,
                          feat_dim=32, device=device)
    g = ds[0]
    parts = dist.metis_partition_assignment(g, num_parts)
    pg = dist.PartitionedGraphCSC.build(g, parts, num_parts)
    src, dst = (t.cpu().numpy() for t in g.edges())
    train = np.arange(0, g.num_edges(), 4)
    edges = np.stack([pg.new_of_old[src[train]], pg.new_of_old[dst[train]]],
                     1)
    ftable = pg.shard_rows(g.ndata["feat"])
    loader = dist.DistEdgeDataLoader(pg, edges, fanouts, batch_size,
                                     num_negatives=num_negatives, seed=0,
                                     device=device)
    return g, pg, ftable, loader


def make_model(in_feats, num_layers, device, seed=0):
    """GraphSAGE ``in_feats``-32-16, in eval mode."""
    return GraphSAGE(in_feats, 32, 16, num_layers=num_layers,
                     generator=generator(seed), device=device).eval()


def batch_inputs(mesh, pg, ftable, batch):
    """A loader batch's blocks, the held parts' pulled features, positive
    pairs, their endpoints' and negatives' slots, and the positive count
    over every part."""
    pos, neg, seeds, pidx, nidx, in_ids, blocks = batch
    x = dist.sparse_all_to_all_pull(mesh, pg.ranges, ftable, in_ids,
                                    axis=AXIS)
    count = int((pos[..., 0] >= 0).sum())
    pos, pidx, nidx = (mesh.local(t, AXIS) for t in (pos, pidx, nidx))
    return blocks, x, pos, pidx, nidx, count


def part_losses(mesh, model, blocks, x, pos, pidx, nidx, count):
    """Each held part's share of the positive and negative logistic
    losses over every part's positive pairs."""
    out = []
    for l, p in enumerate(parts_here(mesh, AXIS)):
        blks = [layer[p] for layer in blocks]
        h = model(blks, x[l] * blks[0].srcdata["_mask"][:, None].to(x.dtype))
        a = h[pidx[l, :, 0]]
        pos_s = (a * h[pidx[l, :, 1]]).sum(-1)
        neg_s = (a[:, None, :] * h[nidx[l]]).sum(-1)
        per = (F.binary_cross_entropy_with_logits(
            pos_s, torch.ones_like(pos_s), reduction="none")
            + F.binary_cross_entropy_with_logits(
                neg_s, torch.zeros_like(neg_s), reduction="none").mean(-1))
        out.append((per * (pos[l, :, 0] >= 0).to(per.dtype)).sum()
                   / max(count, 1))
    return torch.stack(out)


def main(argv=None):
    p = parser(__doc__)
    p.add_argument("--epochs", type=int, default=3)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--fanouts", type=int, nargs="+", default=[5])
    p.add_argument("--num-negatives", type=int, default=2)
    add_parts_argument(p)
    args = parse(p, argv)

    mesh = dist_mesh(args.num_parts, AXIS, args.device)
    g, pg, ftable, loader = setup(mesh, args.batch_size, args.fanouts,
                                  args.num_negatives, args.device)
    print(f"{mesh.shape[AXIS]} partitions, owned nodes: "
          f"{np.diff(pg.ranges)}")
    model = make_model(g.ndata["feat"].shape[1], len(args.fanouts),
                       args.device)
    opt = torch.optim.Adam(model.parameters(), lr=1e-2)
    # the JAX script draws one batch to initialise its model: the same
    # draw here keeps the loader's and the sampler's later draws the same
    next(iter(loader))

    epoch_losses = []
    for epoch in range(args.epochs):
        t0 = time.perf_counter()
        losses = []
        for batch in loader:
            lp = part_losses(mesh, model, *batch_inputs(mesh, pg, ftable,
                                                        batch))
            opt.zero_grad(set_to_none=True)
            lp.sum().backward()
            mesh.sum_grads(list(model.parameters()), AXIS)
            opt.step()
            losses.append(float(total(mesh, lp, AXIS)))
        epoch_losses.append(float(np.mean(losses)))
        print(f"epoch {epoch}: loss {epoch_losses[-1]:.4f} "
              f"({time.perf_counter() - t0:.2f}s, {len(losses)} steps)")
    return {"losses": epoch_losses}


if __name__ == "__main__":
    main()
