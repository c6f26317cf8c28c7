"""GraphSAGE minibatch training with the on-device sampler (counterpart
of ``examples/sage_device_sampler.py``).

The graph's CSC and the feature table live on the device; each epoch's
seed shuffle, every step's neighbour picks, the feature gathers and the
Adam step run there with no host round trip inside the epoch. The JAX
script scans an epoch in one compiled program; here the steps run in an
eager loop over :func:`~dgl_tpu_torch.sampling.device_seed_batches`'
schedule, the sampler drawing from one generator of the device seeded
with the epoch. ``--cpu`` is ``--device cpu``.

Run: python -m dgl_tpu_torch.examples.sage_device_sampler [--epochs 5]
"""
import torch

from .. import add_self_loop, remove_self_loop
from ..data import PubmedGraphDataset
from ..models import DeviceSAGE
from ..sampling import DeviceNeighborSampler, device_seed_batches
from ._common import generator, masked_mean_loss, parse, parser

INFER_BATCH = 2048  # seeds an inference batch (676 input rows a seed)

def load(device):
    """Pubmed with its self-loops, features, labels, masks and int32
    CSC."""
    ds = PubmedGraphDataset(device=device)
    g = add_self_loop(remove_self_loop(ds[0]))
    rel = g._relation(None)
    return (ds, g, g.ndata["feat"], g.ndata["label"], g.ndata["train_mask"],
            g.ndata["test_mask"], rel.csc_indptr.to(torch.int32),
            rel.csc_indices.to(torch.int32))


def make_model(in_feats, num_classes, device, seed=1):
    """DeviceSAGE ``in_feats``-64-``num_classes``, two layers."""
    return DeviceSAGE(in_feats, 64, num_classes, num_layers=2,
                      generator=generator(seed), device=device)


def step(model, opt, sampler, gen, csc, feats, labels, seeds, smask):
    """Sample ``seeds``' MFG, one Adam step; the loss on the device."""
    mfg = sampler.sample(gen, *csc, seeds, seed_mask=smask)
    logits = model(mfg, feats[mfg.input_nodes()])
    loss = masked_mean_loss(logits, labels[seeds], smask)
    opt.zero_grad(set_to_none=True)
    loss.backward()
    opt.step()
    return loss.detach()


def epoch(model, opt, sampler, gen, csc, feats, labels, train_mask, n, B):
    """One epoch over the device's seed schedule; its mean loss."""
    ids, mask = device_seed_batches(gen, n, B, train_mask,
                                    device=feats.device)
    total = torch.zeros((), device=feats.device)
    for i in range(ids.shape[0]):
        total = total + step(model, opt, sampler, gen, csc, feats, labels,
                             ids[i], mask[i])
    return total / ids.shape[0]


def test_accuracy(model, csc, feats, labels, test_mask, n):
    """Inference over every node with fanouts [25, 25] (Pubmed's mean
    in-degree is about 5), in padded batches of ``INFER_BATCH`` seeds; the
    test nodes' accuracy."""
    batch = INFER_BATCH
    device = feats.device
    infer = DeviceNeighborSampler([25, 25])
    gen = torch.Generator(device=device).manual_seed(99)
    correct = []
    with torch.no_grad():
        for lo in range(0, n, batch):
            seeds = torch.arange(lo, min(lo + batch, n), device=device)
            pad = batch - seeds.shape[0]
            smask = torch.cat([torch.ones(seeds.shape[0], dtype=torch.bool,
                                          device=device),
                               torch.zeros(pad, dtype=torch.bool,
                                           device=device)])
            seeds = torch.cat([seeds, torch.zeros(pad, dtype=seeds.dtype,
                                                  device=device)])
            mfg = infer.sample(gen, *csc, seeds, seed_mask=smask)
            pred = model(mfg, feats[mfg.input_nodes()]).argmax(-1)
            real = seeds[smask]
            sel = test_mask[real]
            correct.append((pred[smask] == labels[real])[sel])
    return float(torch.cat(correct).float().mean())


def main(argv=None):
    p = parser(__doc__)
    p.add_argument("--epochs", type=int, default=5)
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--cpu", action="store_true", help="--device cpu")
    args = parse(p, argv)

    ds, g, feats, labels, train_mask, test_mask, *csc = load(args.device)
    n = g.num_nodes()
    sampler = DeviceNeighborSampler([10, 10])
    model = make_model(feats.shape[1], ds.num_classes, args.device)
    opt = torch.optim.Adam(model.parameters(), lr=1e-2)

    losses = []
    for e in range(args.epochs):
        gen = torch.Generator(device=args.device).manual_seed(e)
        losses.append(float(epoch(model, opt, sampler, gen, csc, feats,
                                  labels, train_mask, n, args.batch_size)))
        print(f"epoch {e}: mean loss {losses[-1]:.4f}", flush=True)
    acc = test_accuracy(model, csc, feats, labels, test_mask, n)
    print(f"test accuracy: {acc:.4f}")
    return {"losses": losses, "test_accuracy": acc}


if __name__ == "__main__":
    main()
