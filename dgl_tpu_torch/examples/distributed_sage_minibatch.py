"""Distributed minibatch GraphSAGE: the DistDGL training workflow over a
mesh of parts (counterpart of ``examples/distributed_sage_minibatch.py``;
reference ``examples/distributed/graphsage/node_classification.py``).

The graph is partitioned part-major (``PartitionedGraphCSC``); every part
samples fixed-shape blocks for the seeds it owns (``node_split``
semantics); the input features and labels stay row-sharded and are
fetched each step with one ``sparse_all_to_all_pull``; the parts'
gradients are summed into one optimiser. The JAX script maps its model
over the parts' stacked blocks in one compiled step; here each held
part's blocks run in turn, eagerly. The JAX script applies the model
deterministically, so dropout is off.

One process holds ``--num-parts`` parts (default 8), or, under
``tools/launch.py``, each process holds one.

Run: python -m dgl_tpu_torch.examples.distributed_sage_minibatch [--epochs 3]
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


def setup(mesh, batch_size, fanouts, device, seed=None):
    """The graph, its part-major CSC over the multilevel assignment, the
    row-sharded feature and label tables, and the loader over the
    training seeds each part owns, shuffled by the numpy generator made
    from ``seed`` (unseeded by default, as the JAX script's)."""
    num_parts = mesh.shape[AXIS]
    ds = SyntheticDataset(num_nodes=4096, num_edges=40_000, num_classes=8,
                          feat_dim=64, device=device)
    g = ds[0]
    parts = dist.metis_partition_assignment(g, num_parts)
    pg = dist.PartitionedGraphCSC.build(g, parts, num_parts)
    train_old = np.nonzero(g.ndata["train_mask"].cpu().numpy())[0]
    train_new = np.sort(pg.new_of_old[train_old])
    ftable = pg.shard_rows(g.ndata["feat"])
    ltable = pg.shard_rows(g.ndata["label"].float()[:, None])
    sampler = dist.DistNeighborSampler(pg, fanouts, batch_size, seed=0,
                                       device=device)
    loader = dist.DistNodeDataLoader(pg, train_new, sampler, batch_size,
                                     shuffle=True, seed=seed)
    return ds, g, pg, ftable, ltable, loader


def make_model(in_feats, num_classes, num_layers, device, seed=0):
    """GraphSAGE ``in_feats``-64-``num_classes``, in eval mode."""
    return GraphSAGE(in_feats, 64, num_classes, num_layers=num_layers,
                     generator=generator(seed), device=device).eval()


def batch_inputs(mesh, pg, ftable, ltable, batch):
    """A loader batch's blocks, the held parts' pulled features, labels
    and output mask, and the seed count over every part."""
    in_ids, out_ids, blocks = batch
    x = dist.sparse_all_to_all_pull(mesh, pg.ranges, ftable, in_ids,
                                    axis=AXIS)
    y = dist.sparse_all_to_all_pull(mesh, pg.ranges, ltable,
                                    out_ids.clamp(min=0),
                                    axis=AXIS)[..., 0].long()
    m = mesh.local(out_ids >= 0, AXIS).to(x.dtype)
    return blocks, x, y, m, int((out_ids >= 0).sum())


def part_losses(mesh, model, blocks, x, y, m, count):
    """Each held part's share of the masked cross-entropy over every
    part's seeds."""
    out = []
    for l, p in enumerate(parts_here(mesh, AXIS)):
        blks = [layer[p] for layer in blocks]
        h = x[l] * blks[0].srcdata["_mask"][:, None].to(x.dtype)
        logits = model(blks, h)[: y.shape[1]]
        ls = F.cross_entropy(logits, y[l], reduction="none")
        out.append((ls * m[l]).sum() / max(count, 1))
    return torch.stack(out)


def main(argv=None):
    p = parser(__doc__)
    p.add_argument("--epochs", type=int, default=3)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--fanouts", type=int, nargs="+", default=[5, 5])
    add_parts_argument(p)
    args = parse(p, argv)

    mesh = dist_mesh(args.num_parts, AXIS, args.device)
    ds, g, pg, ftable, ltable, loader = setup(mesh, args.batch_size,
                                              args.fanouts, args.device)
    print(f"{mesh.shape[AXIS]} partitions, owned nodes: "
          f"{np.diff(pg.ranges)}")
    model = make_model(g.ndata["feat"].shape[1], ds.num_classes,
                       len(args.fanouts), args.device)
    opt = torch.optim.Adam(model.parameters(), lr=1e-2)
    # the JAX script draws one batch to initialise its model: the same
    # draw here keeps the loader's and the sampler's later draws the same
    next(iter(loader))

    epoch_losses = []
    for epoch in range(args.epochs):
        t0 = time.perf_counter()
        losses = []
        for batch in loader:
            lp = part_losses(mesh, model, *batch_inputs(
                mesh, pg, ftable, ltable, batch))
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
