"""Distributed heterogeneous (R-GCN) minibatch training: DistDGL's
ogbn-mag workflow over a mesh of parts (counterpart of
``examples/distributed_rgcn_minibatch.py``; reference
``examples/distributed/rgcn``).

The heterograph is made homogeneous (``to_homogeneous``), partitioned
part-major, and every part samples fixed-shape blocks with a fanout a
relation for its own seeds (``DistEtypeNeighborSampler``); the slots'
edge types are static, so ``RelGraphConv``'s typed projection sees one
layout; the features ride the row-sharded all-to-all pull. Each held
part runs in turn, eagerly.

One process holds ``--num-parts`` parts (default 8), or, under
``tools/launch.py``, each process holds one.

Run: python -m dgl_tpu_torch.examples.distributed_rgcn_minibatch [--epochs 3]
"""
import time

import numpy as np
import torch
from torch import nn

from .. import distributed as dist
from ..base import ETYPE, NTYPE
from ..convert import to_homogeneous
from ..data import SyntheticHeteroDataset
from ..nn import RelGraphConv
from ._common import (add_parts_argument, dist_mesh, generator, parse,
                      parser, total)

AXIS = "dp"
FANOUT = 4


def setup(mesh, batch_size, device, seed=None):
    """The dataset, its homogeneous graph, the part-major CSC, the feature
    and label tables, the etype sampler (4 a relation, 2 layers), the
    loader over the category's nodes (shuffled by the numpy generator made
    from ``seed``, unseeded by default as the JAX script's) and the slots'
    edge types."""
    num_parts = mesh.shape[AXIS]
    ds = SyntheticHeteroDataset(device=device)
    hg = ds[0]
    homo = to_homogeneous(hg, ndata=["feat"])
    etypes = homo.edata[ETYPE].cpu().numpy()
    num_rels = len(hg.canonical_etypes)
    parts = dist.metis_partition_assignment(homo, num_parts)
    pg = dist.PartitionedGraphCSC.build(homo, parts, num_parts)
    cat = np.nonzero(homo.ndata[NTYPE].cpu().numpy()
                     == hg.ntypes.index(ds.predict_ntype))[0]
    labels = torch.zeros(homo.num_nodes(), device=device)
    labels[torch.from_numpy(cat).to(device)] = (
        hg.nodes[ds.predict_ntype].data["label"].float())
    fanouts = [[FANOUT] * num_rels] * 2
    sampler = dist.DistEtypeNeighborSampler(pg, etypes, fanouts, batch_size,
                                            seed=0, device=device)
    loader = dist.DistNodeDataLoader(pg, np.sort(pg.new_of_old[cat]),
                                     sampler, batch_size, shuffle=True,
                                     seed=seed)
    slot_et = [torch.from_numpy(sampler.slot_etypes(i)).to(device)
               for i in range(len(fanouts))]
    return (ds, hg, homo, pg, pg.shard_rows(homo.ndata["feat"]),
            pg.shard_rows(labels[:, None]), loader, slot_et)


class RGCN(nn.Module):
    """Two ``RelGraphConv`` layers over the blocks, no self-loop, ReLU and
    the second block's source mask between them."""

    def __init__(self, in_feats, hidden, num_classes, num_rels, slot_et, *,
                 generator=None, device="cuda"):
        super().__init__()
        self.l1 = RelGraphConv(in_feats, hidden, num_rels, self_loop=False,
                               generator=generator, device=device)
        self.l2 = RelGraphConv(hidden, num_classes, num_rels,
                               self_loop=False, generator=generator,
                               device=device)
        self.slot_et = slot_et

    def forward(self, blocks, x):
        h = torch.relu(self.l1(blocks[0], x, self.slot_et[0]))
        h = h * blocks[1].srcdata["_mask"][:, None].to(h.dtype)
        return self.l2(blocks[1], h, self.slot_et[1])


def make_model(in_feats, hidden, num_classes, num_rels, slot_et, device,
               seed=0):
    return RGCN(in_feats, hidden, num_classes, num_rels,
                [t.to(device) for t in slot_et], generator=generator(seed),
                device=device)


def main(argv=None):
    from .distributed_sage_minibatch import batch_inputs, part_losses

    p = parser(__doc__)
    p.add_argument("--epochs", type=int, default=3)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--hidden", type=int, default=32)
    add_parts_argument(p)
    args = parse(p, argv)

    mesh = dist_mesh(args.num_parts, AXIS, args.device)
    ds, hg, homo, pg, ftable, ltable, loader, slot_et = setup(
        mesh, args.batch_size, args.device)
    num_rels = len(hg.canonical_etypes)
    print(f"{mesh.shape[AXIS]} partitions, {num_rels} relations, "
          f"category={ds.predict_ntype!r}")
    model = make_model(homo.ndata["feat"].shape[1], args.hidden,
                       ds.num_classes, num_rels, slot_et, args.device)
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
