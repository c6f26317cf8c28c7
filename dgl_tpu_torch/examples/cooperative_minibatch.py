"""Cooperative minibatching with a row-sharded embedding table
(counterpart of ``examples/cooperative_minibatch.py``; reference
GraphBolt's cooperative minibatching, ``impl/cooperative_conv.py``, and
``DistEmbedding``): the batch's input rows are requested from the parts
that own them through the differentiable sparse all-to-all, so the
gradients flow back to the owning parts, and Adam updates the table with
the model.

Each step's request list is split evenly over the parts, as the JAX
script shards it over its mesh. One process holds ``--num-parts`` parts
(default 8); under ``tools/launch.py`` each process holds one part of the
table and its share of the requests, the pulled rows are gathered so that
every process runs the same model step, and the gradient of each pulled
row goes back to the part that owns it.

Run: python -m dgl_tpu_torch.examples.cooperative_minibatch [--steps 20]
"""
import numpy as np
import torch
from torch import nn

from .. import graph
from ..base import NID
from ..dataloading import FixedShapeNeighborSampler
from ..distributed.cooperative import sparse_all_to_all_pull
from ..models import GraphSAGE
from ._common import (add_parts_argument, dist_mesh, generator,
                      masked_mean_loss, parse, parser)

AXIS = "gp"
N, E, F_IN, C = 4096, 40_000, 32, 8


class _Gathered(torch.autograd.Function):
    """Every part's pulled rows from the parts held here; the backward
    keeps the held parts' rows of the gradient (every process computes the
    same step, so its gradient needs no sum)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return mesh.all_gather(x, AXIS)

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        lo = mesh.coord(AXIS)
        return g[lo:lo + mesh.parts(AXIS)], None


def setup(mesh, batch_size, device):
    """The random graph, the labels (``id % 8``), the part ranges, the
    table's initial rows (class centroids plus noise, (P, rows, F)), the
    sampler (seed 0), and the numpy generator, all drawn from numpy seed 0
    in the JAX script's order."""
    n_dev = mesh.shape[AXIS]
    rng = np.random.default_rng(0)
    g = graph((rng.integers(0, N, E), rng.integers(0, N, E)), num_nodes=N,
              device=device)
    labels = (np.arange(N) % C).astype(np.int64)
    rows = N // n_dev
    ranges = np.arange(n_dev + 1) * rows
    centroids = rng.normal(size=(C, F_IN)).astype(np.float32)
    init = (centroids[labels]
            + rng.normal(size=(N, F_IN)).astype(np.float32) * 0.5)
    sampler = FixedShapeNeighborSampler([5, 5], batch_size, seed=0,
                                        device=device)
    return g, labels, ranges, init.reshape(n_dev, rows, F_IN), sampler, rng


class Model(nn.Module):
    """GraphSAGE 32-64-8 (eval mode: the JAX script applies it
    deterministically) and the parts' table rows held here."""

    def __init__(self, mesh, table, device, seed=0):
        super().__init__()
        self.sage = GraphSAGE(F_IN, 64, C, num_layers=2,
                              generator=generator(seed),
                              device=device).eval()
        self.table = nn.Parameter(mesh.local(
            torch.from_numpy(table), AXIS).to(device))


def requests(ids, n_dev):
    """The input ids padded to a multiple of the part count, one row a
    part."""
    reqs = np.zeros((n_dev, -(-ids.shape[0] // n_dev)), np.int64)
    reqs.reshape(-1)[: ids.shape[0]] = ids
    return torch.from_numpy(reqs)


def step_loss(mesh, model, ranges, blocks, labels):
    """Pull the batch's input rows cooperatively, run the model over the
    blocks; the masked cross-entropy of the output slots."""
    ids = blocks[0].srcdata[NID].cpu().numpy()
    reqs = requests(ids, mesh.shape[AXIS]).to(mesh.device)
    x = sparse_all_to_all_pull(mesh, ranges, model.table, reqs, axis=AXIS)
    x = _Gathered.apply(x, mesh).reshape(-1, F_IN)[: ids.shape[0]]
    logits = model.sage(blocks, x)
    out = blocks[-1].dstdata
    y = torch.from_numpy(labels).to(logits.device)[out[NID]]
    return masked_mean_loss(logits, y, out["_mask"].float())


def main(argv=None):
    p = parser(__doc__)
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--batch-size", type=int, default=64)
    add_parts_argument(p)
    args = parse(p, argv)

    mesh = dist_mesh(args.num_parts, AXIS, args.device)
    B = args.batch_size
    g, labels, ranges, table, sampler, rng = setup(mesh, B, args.device)
    # the JAX script samples one batch to initialise its model: the same
    # draw here keeps the sampler's later batches the same
    sampler.sample_blocks(g, np.arange(B))
    model = Model(mesh, table, args.device)
    opt = torch.optim.Adam(model.parameters(), lr=1e-2)

    all_ids = rng.permutation(N)
    losses = []
    for i in range(args.steps):
        seeds = all_ids[(i * B) % (N - B):][:B]
        _, _, blocks = sampler.sample_blocks(g, seeds)
        loss = step_loss(mesh, model, ranges, blocks, labels)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        losses.append(loss.detach())
        if i % 5 == 0:
            print(f"step {i} loss {float(losses[-1]):.4f}")
    print(f"final loss {float(losses[-1]):.4f}")
    return {"losses": torch.stack(losses).tolist()}


if __name__ == "__main__":
    main()
