"""Distributed GraphSAGE minibatch training on the on-device sampler
(counterpart of ``examples/device_dist_sage.py``).

Each part holds its partition's CSC on the device; a layer's expansion
is one masked ``all_to_all`` request/response pair
(``DeviceDistSampler``), then the feature and label pulls, the forward
and backward, and the parts' mean gradient. The JAX script fuses one
rank's epoch into a ``shard_map`` program scanned over its steps; here
the steps run in an eager loop, every held part's loss in turn.

One process holds ``--num-parts`` parts (default 8), or, under
``tools/launch.py``, each process holds one.

Run: python -m dgl_tpu_torch.examples.device_dist_sage
"""
import numpy as np
import torch
import torch.nn.functional as F

from .. import distributed as dist
from .. import graph
from ..models import DeviceSAGE
from ..sampling.device_sampler import DeviceMFG
from ._common import (add_parts_argument, dist_mesh, generator, parse,
                      parser, parts_here)

AXIS = "dp"
N, E, F_IN, C = 20_000, 200_000, 32, 7
B, S, FANOUTS = 128, 8, [5, 5]


def setup(mesh, device):
    """The uniform random graph, its part-major CSC over the multilevel
    assignment and the CSC shards, the row-sharded features and labels,
    and every part's (S, B) seeds, drawn from numpy seed 0 in the JAX
    script's order."""
    num_parts = mesh.shape[AXIS]
    rng = np.random.default_rng(0)
    src = rng.integers(0, N, E)
    dst = rng.integers(0, N, E)
    g = graph((src, dst), num_nodes=N, device=device)
    parts = dist.metis_partition_assignment(g, num_parts)
    pg = dist.PartitionedGraphCSC.build(g, parts, num_parts)
    ip, ix = dist.shard_csc_arrays(pg, device=device)
    feats = pg.shard_rows(rng.normal(size=(N, F_IN)).astype(np.float32),
                          device=device)
    labels = pg.shard_rows(
        rng.integers(0, C, N).astype(np.float32)[:, None], device=device)
    seeds = torch.from_numpy(
        rng.integers(0, N, (num_parts, S, B)).astype(np.int64)).to(device)
    return g, pg, ip, ix, feats, labels, seeds


def make_model(device, seed=1):
    """DeviceSAGE 32-64-7, two layers."""
    return DeviceSAGE(F_IN, 64, C, num_layers=2, generator=generator(seed),
                      device=device)


def part_mfg(mfg, l):
    """The ``l``-th held part's MFG of a (parts, ...) MFG."""
    return DeviceMFG([f[l] for f in mfg.frontiers], [n[l] for n in mfg.nbrs],
                     [m[l] for m in mfg.masks], mfg.seed_mask[l])


def part_losses(mesh, model, sampler, gens, pg, ip, ix, feats, labels,
                seeds):
    """Sample the held parts' MFGs for ``seeds`` (P, B), pull their
    features and labels; each held part's mean cross-entropy over the
    part count (their sum is the parts' mean)."""
    sd = mesh.local(seeds, AXIS)
    mfg = sampler.sample_shard(mesh, gens, ip, ix, sd, axis=AXIS)
    x = dist.pull_rows_in_shard_map(mesh, pg.ranges, feats,
                                    mfg.input_nodes(), axis=AXIS)
    y = dist.pull_rows_in_shard_map(mesh, pg.ranges, labels, sd,
                                    axis=AXIS)[..., 0].long()
    P = mesh.shape[AXIS]
    return torch.stack([F.cross_entropy(model(part_mfg(mfg, l), x[l]), y[l])
                        for l in range(x.shape[0])]) / P


def main(argv=None):
    p = parser(__doc__)
    add_parts_argument(p)
    args = parse(p, argv)

    mesh = dist_mesh(args.num_parts, AXIS, args.device)
    P = mesh.shape[AXIS]
    g, pg, ip, ix, feats, labels, seeds = setup(mesh, args.device)
    sampler = dist.DeviceDistSampler(FANOUTS, pg.ranges)
    print(f"analytic comm: "
          f"{sampler.comm_bytes_per_sample(B, P) / 1e3:.0f} KB/step/rank")
    model = make_model(args.device)
    opt = torch.optim.Adam(model.parameters(), lr=1e-2)
    gens = [torch.Generator(device=args.device).manual_seed(2 + p)
            for p in parts_here(mesh, AXIS)]

    losses = []
    for s in range(S):
        lp = part_losses(mesh, model, sampler, gens, pg, ip, ix, feats,
                         labels, seeds[:, s])
        opt.zero_grad(set_to_none=True)
        lp.sum().backward()
        mesh.sum_grads(list(model.parameters()), AXIS)
        opt.step()
        losses.append(lp.detach()[0] * P)
    losses = torch.stack(losses).cpu().numpy()
    print("per-step losses (rank 0):", np.round(losses, 3))
    return {"losses": losses.tolist()}


if __name__ == "__main__":
    main()
