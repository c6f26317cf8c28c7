"""Command-line trainer (counterpart of ``dgl_tpu/cli.py``; reference
``dglgo/``: ``dgl configure/train/recipe``).

Usage:
    python -m dgl_tpu_torch recipe list
    python -m dgl_tpu_torch configure nodepred --model gcn --dataset cora > cfg.json
    python -m dgl_tpu_torch train --cfg cfg.json
    python -m dgl_tpu_torch train --pipeline nodepred --model gat --dataset citeseer
    python -m dgl_tpu_torch export --cfg cfg.json --output train.py --checkpoint ck.npz
    python -m dgl_tpu_torch apply --checkpoint ck.npz --output predictions.npy

Pipelines mirror dglgo's: nodepred (full graph), nodepred-ns (neighbour
sampling), linkpred and graphpred, each trained with ``torch.optim.Adam``.
Every command takes ``--device`` (default ``cuda``); ``train`` and
``apply`` stop with an error naming CUDA when the card is missing, unless
``--device cpu`` asks for the CPU. ``train`` and ``apply`` are also the
Python entry points :func:`train` and :func:`apply`.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch
import torch.nn.functional as F

RECIPES = {
    "nodepred_gcn_cora": {"pipeline": "nodepred", "model": "gcn", "dataset": "cora", "epochs": 200, "lr": 1e-2, "hidden": 16},
    "nodepred_gat_cora": {"pipeline": "nodepred", "model": "gat", "dataset": "cora", "epochs": 200, "lr": 5e-3, "hidden": 8},
    "nodepred_sage_cora": {"pipeline": "nodepred", "model": "sage", "dataset": "cora", "epochs": 200, "lr": 1e-2, "hidden": 64},
    "nodepred-ns_sage_synthetic": {"pipeline": "nodepred-ns", "model": "sage", "dataset": "synthetic", "epochs": 5, "lr": 1e-3, "hidden": 128, "batch_size": 256, "fanouts": [10, 10]},
    "linkpred_sage_synthetic": {"pipeline": "linkpred", "model": "sage", "dataset": "synthetic", "epochs": 50, "lr": 1e-3, "hidden": 64},
    "graphpred_gin_synthetic": {"pipeline": "graphpred", "model": "gin", "dataset": "graphcls", "epochs": 60, "lr": 5e-3, "hidden": 32},
}

PIPELINES = ["nodepred", "nodepred-ns", "linkpred", "graphpred"]


class NoCUDA(RuntimeError):
    """The command asked for CUDA where no card answers."""


def _device(name) -> torch.device:
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise NoCUDA(f"device {str(dev)!r} needs CUDA, and "
                     "torch.cuda.is_available() is false (no card, or a "
                     "CPU-only torch); pass --device cpu to run on the CPU")
    return dev


def _generator(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def _load_dataset(name: str, device="cuda"):
    from .data import (CiteseerGraphDataset, CoraGraphDataset,
                       PubmedGraphDataset, SyntheticDataset)

    table = {
        "cora": CoraGraphDataset,
        "citeseer": CiteseerGraphDataset,
        "pubmed": PubmedGraphDataset,
        "synthetic": lambda device: SyntheticDataset(
            num_nodes=20_000, num_edges=200_000, num_classes=16, feat_dim=64,
            device=device,
        ),
    }
    if name not in table:
        raise SystemExit(f"unknown dataset {name!r}; options: {list(table)}")
    return table[name](device=device)


def _build_model(name: str, in_feats: int, hidden: int, out_feats: int,
                 num_layers: int = 2, device="cuda"):
    """The pipeline's model, its parameters drawn from seed 0."""
    from .models import GAT, GCN, GraphSAGE

    kw = dict(num_layers=num_layers, generator=_generator(0), device=device)
    if name == "gcn":
        return GCN(in_feats, hidden, out_feats, **kw)
    if name == "gat":
        return GAT(in_feats, hidden, out_feats, **kw)
    if name == "sage":
        return GraphSAGE(in_feats, hidden, out_feats, **kw)
    raise SystemExit(f"unknown model {name!r}; options: gcn gat sage")


def _run_nodepred(cfg: dict, device):
    from . import add_self_loop, remove_self_loop

    ds = _load_dataset(cfg["dataset"], device)
    g = add_self_loop(remove_self_loop(ds[0]))
    feat = g.ndata["feat"]
    labels = g.ndata["label"].long()
    train_mask = g.ndata["train_mask"].float()
    test_mask = g.ndata["test_mask"].bool()
    model = _build_model(
        cfg["model"], feat.shape[1], cfg.get("hidden", 16), ds.num_classes,
        device=device,
    )
    opt = torch.optim.Adam(model.parameters(), lr=cfg.get("lr", 1e-2))
    torch.manual_seed(1)  # the dropout masks

    t0 = time.perf_counter()
    model.train()
    for epoch in range(cfg.get("epochs", 200)):
        ls = F.cross_entropy(model(g, feat), labels, reduction="none")
        loss = (ls * train_mask).sum() / train_mask.sum()
        opt.zero_grad()
        loss.backward()
        opt.step()
        if epoch % 20 == 0:
            print(f"epoch {epoch:4d} loss {loss.item():.4f}")
    model.eval()
    with torch.no_grad():
        pred = model(g, feat).argmax(-1)
    acc = float(((pred == labels) & test_mask).sum() / test_mask.sum())
    print(
        f"done in {time.perf_counter()-t0:.2f}s; test accuracy {acc:.4f}"
    )
    return acc


def _run_nodepred_ns(cfg: dict, device):
    from . import dataloading
    from .base import NID

    ds = _load_dataset(cfg["dataset"], device)
    g = ds[0]
    feats = g.ndata["feat"]
    labels = g.ndata["label"].long()
    train_ids = torch.nonzero(g.ndata["train_mask"]).reshape(-1).cpu().numpy()
    fanouts = cfg.get("fanouts", [10, 10])
    bs = cfg.get("batch_size", 256)
    sampler = dataloading.FixedShapeNeighborSampler(
        fanouts, batch_size=bs, seed=0, device=device)
    model = _build_model(
        cfg["model"], feats.shape[1], cfg.get("hidden", 128), ds.num_classes,
        num_layers=len(fanouts), device=device,
    )
    # the reference trains this pipeline without dropout
    model.eval()
    opt = torch.optim.Adam(model.parameters(), lr=cfg.get("lr", 1e-3))

    losses = []
    for epoch in range(cfg.get("epochs", 5)):
        loader = dataloading.DataLoader(
            g, train_ids, sampler, batch_size=bs, shuffle=True, seed=epoch,
            device=device,
        )
        tot, nb = 0.0, 0
        t0 = time.perf_counter()
        for _, _, blocks in loader:
            x = (feats[blocks[0].srcdata[NID].long()]
                 * blocks[0].srcdata["_mask"][:, None])
            y = labels[blocks[-1].dstdata[NID].long()]
            ymask = blocks[-1].dstdata["_mask"].float()
            ls = F.cross_entropy(model(blocks, x), y, reduction="none")
            loss = (ls * ymask).sum() / ymask.sum().clamp_min(1)
            opt.zero_grad()
            loss.backward()
            opt.step()
            tot += loss.item()
            nb += 1
        losses.append(tot / nb)
        print(f"epoch {epoch} loss {tot/nb:.4f} ({time.perf_counter()-t0:.2f}s)")
    return losses


class _GraphPredGIN(torch.nn.Module):
    """The graphpred pipeline's model: two ``GINConv`` (sum) layers over
    two-layer MLPs, a ReLU between, a mean readout and a linear head
    (flax ``Dense`` initialisation, drawn from ``generator``)."""

    def __init__(self, in_feats: int, hidden: int, num_classes: int, *,
                 generator=None, device="cuda"):
        from .nn._init import dense
        from .nn.conv import GINConv

        super().__init__()

        def mlp(i):
            return torch.nn.Sequential(
                dense(i, hidden, generator=generator), torch.nn.ReLU(),
                dense(hidden, hidden, generator=generator))

        self.gin0 = GINConv(apply_func=mlp(in_feats), aggregator_type="sum",
                            device=device)
        self.gin1 = GINConv(apply_func=mlp(hidden), aggregator_type="sum",
                            device=device)
        self.head = dense(hidden, num_classes, generator=generator)
        self.to(device)

    def forward(self, g, h):
        from . import readout

        h = torch.relu(self.gin0(g, h))
        h = self.gin1(g, h)
        with g.local_scope() as gg:
            gg.ndata["h"] = h
            hg = readout.mean_nodes(gg, "h")
        return self.head(hg)


def _run_graphpred(cfg: dict, device):
    from .batch import batch as batch_graphs
    from .data import GraphClassificationDataset

    ds = GraphClassificationDataset(num_graphs=96, device=device)
    graphs = [ds[i][0] for i in range(len(ds))]
    labels = np.array([int(ds[i][1]) for i in range(len(ds))])
    bg = batch_graphs(graphs)
    x = bg.ndata["feat"]
    y = torch.from_numpy(labels).to(device)
    model = _GraphPredGIN(x.shape[1], cfg.get("hidden", 32), ds.num_classes,
                          generator=_generator(0), device=device)
    opt = torch.optim.Adam(model.parameters(), lr=cfg.get("lr", 5e-3))

    losses = []
    for epoch in range(cfg.get("epochs", 60)):
        loss = F.cross_entropy(model(bg, x), y)
        opt.zero_grad()
        loss.backward()
        opt.step()
        losses.append(loss.item())
        if epoch % 20 == 0:
            print(f"epoch {epoch} loss {losses[-1]:.4f}")
    with torch.no_grad():
        pred = model(bg, x).argmax(-1).cpu().numpy()
    acc = (pred == labels).mean()
    print(f"graph classification accuracy {acc:.4f}")
    return losses


def _run_linkpred(cfg: dict, device):
    """The reference runs ``examples/link_prediction.py``; so does this:
    :mod:`dgl_tpu_torch.examples.link_prediction`'s training and AUC."""
    from .examples import link_prediction

    model, data, losses = link_prediction.train(cfg.get("epochs", 50),
                                                device)
    print(f"AUC {link_prediction.auc(model, *data):.4f}")
    return losses


_EXPORT_TEMPLATE = '''\
"""Standalone {pipeline} training script generated by `dgl_tpu_torch export`
(reference ``dglgo/cli/export_cli.py``: the same config -> script codegen,
without the yaml/typer/jinja stack). Edit freely: it has no dependency on
the CLI's command line."""
import time

import torch
import torch.nn.functional as F

import dgl_tpu_torch
from dgl_tpu_torch import add_self_loop, remove_self_loop
from dgl_tpu_torch.checkpoint import save_checkpoint
from dgl_tpu_torch.cli import _build_model, _load_dataset

CFG = {cfg!r}


def main():
    device = torch.device(CFG.get("device", "cuda"))
    ds = _load_dataset(CFG["dataset"], device)
    g = add_self_loop(remove_self_loop(ds[0]))
    feat = g.ndata["feat"]
    labels = g.ndata["label"].long()
    train_mask = g.ndata["train_mask"].float()
    test_mask = g.ndata["test_mask"].bool()
    model = _build_model(CFG["model"], feat.shape[1],
                         CFG.get("hidden", 16), ds.num_classes,
                         device=device)
    opt = torch.optim.Adam(model.parameters(), lr=CFG.get("lr", 1e-2))
    torch.manual_seed(1)

    t0 = time.perf_counter()
    model.train()
    for epoch in range(CFG.get("epochs", 200)):
        ls = F.cross_entropy(model(g, feat), labels, reduction="none")
        loss = (ls * train_mask).sum() / train_mask.sum()
        opt.zero_grad()
        loss.backward()
        opt.step()
        if epoch % 20 == 0:
            print(f"epoch {{epoch:4d}} loss {{loss.item():.4f}}")
    model.eval()
    with torch.no_grad():
        pred = model(g, feat).argmax(-1)
    acc = float(((pred == labels) & test_mask).sum() / test_mask.sum())
    print(f"done in {{time.perf_counter()-t0:.2f}}s; "
          f"test accuracy {{acc:.4f}}")
    if CFG.get("checkpoint"):
        save_checkpoint(CFG["checkpoint"], model.state_dict(),
                        step=CFG.get("epochs"))
        print("checkpoint saved to", CFG["checkpoint"])


if __name__ == "__main__":
    main()
'''


def _run_apply(cfg: dict, device):
    """Inference from a trained checkpoint (reference
    ``dglgo/apply_pipeline/nodepred``): writes the per-node predictions
    (int64) and prints the accuracy over every labelled node."""
    from . import add_self_loop, remove_self_loop
    from .checkpoint import load_checkpoint

    ds = _load_dataset(cfg["dataset"], device)
    g = add_self_loop(remove_self_loop(ds[0]))
    feat = g.ndata["feat"]
    model = _build_model(
        cfg["model"], feat.shape[1], cfg.get("hidden", 16), ds.num_classes,
        device=device,
    )
    state, _step = load_checkpoint(cfg["checkpoint"], model.state_dict(),
                                   return_step=True)
    model.load_state_dict(state)
    model.eval()
    with torch.no_grad():
        pred = model(g, feat).argmax(-1).cpu().numpy()
    out = cfg.get("output", "predictions.npy")
    np.save(out, pred)
    labels = g.ndata["label"].cpu().numpy()
    acc = float((pred == labels).mean())
    print(f"predictions for {pred.shape[0]} nodes saved to {out}; "
          f"all-node accuracy {acc:.4f}")
    return out


def train(cfg: dict, device="cuda"):
    """Run ``cfg``'s pipeline on ``device``. Returns the test accuracy
    (nodepred) or the losses by epoch (the other pipelines)."""
    device = _device(device)
    pipeline = cfg.get("pipeline", "nodepred")
    if pipeline == "nodepred":
        return _run_nodepred(cfg, device)
    if pipeline == "nodepred-ns":
        return _run_nodepred_ns(cfg, device)
    if pipeline == "linkpred":
        return _run_linkpred(cfg, device)
    if pipeline == "graphpred":
        return _run_graphpred(cfg, device)
    raise SystemExit(f"unknown pipeline {pipeline!r}")


def apply(cfg: dict, device="cuda"):
    """Predict every node of ``cfg["dataset"]`` with the nodepred model of
    ``cfg["checkpoint"]`` on ``device``; returns the predictions' path."""
    cfg = {"model": "gcn", "dataset": "cora", "hidden": 16, **cfg}
    return _run_apply(cfg, _device(device))


def _read_cfg(path):
    with open(path) as f:
        return json.load(f)


def main(argv=None):
    p = argparse.ArgumentParser(prog="dgl_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    rp = sub.add_parser("recipe", help="list built-in recipes")
    rp.add_argument("action", choices=["list", "get"])
    rp.add_argument("name", nargs="?")

    cp = sub.add_parser("configure", help="emit a pipeline config JSON")
    cp.add_argument("pipeline", choices=PIPELINES)
    cp.add_argument("--model", default="gcn")
    cp.add_argument("--dataset", default="cora")
    cp.add_argument("--epochs", type=int, default=200)
    cp.add_argument("--lr", type=float, default=1e-2)
    cp.add_argument("--hidden", type=int, default=16)

    tp = sub.add_parser("train", help="run a pipeline")
    tp.add_argument("--cfg", help="config JSON path")
    tp.add_argument("--pipeline", choices=PIPELINES)
    tp.add_argument("--model", default="gcn")
    tp.add_argument("--dataset", default="cora")
    tp.add_argument("--epochs", type=int)
    tp.add_argument("--lr", type=float)
    tp.add_argument("--hidden", type=int)

    ep = sub.add_parser(
        "export", help="generate a standalone training script from a config "
        "(reference dglgo export)")
    ep.add_argument("--cfg", help="config JSON path")
    ep.add_argument("--output", default="script.py")
    ep.add_argument("--checkpoint", help="path the script saves params to")

    ap = sub.add_parser(
        "apply", help="run inference from a trained checkpoint "
        "(reference dglgo apply)")
    ap.add_argument("--cfg", help="config JSON path")
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--model", default="gcn")
    ap.add_argument("--dataset", default="cora")
    ap.add_argument("--hidden", type=int, default=16)
    ap.add_argument("--output", default="predictions.npy")

    for sp in (rp, cp, tp, ep, ap):
        sp.add_argument("--device", default="cuda",
                        help="torch device to run on (default cuda)")

    args = p.parse_args(argv)

    if args.cmd == "recipe":
        if args.action == "list":
            for name in RECIPES:
                print(name)
        else:
            print(json.dumps(RECIPES[args.name], indent=2))
        return

    if args.cmd == "configure":
        print(
            json.dumps(
                {
                    "pipeline": args.pipeline,
                    "model": args.model,
                    "dataset": args.dataset,
                    "epochs": args.epochs,
                    "lr": args.lr,
                    "hidden": args.hidden,
                },
                indent=2,
            )
        )
        return

    if args.cmd == "export":
        if args.cfg:
            cfg = _read_cfg(args.cfg)
        else:
            cfg = {"pipeline": "nodepred", "model": "gcn",
                   "dataset": "cora"}
        if cfg.get("pipeline", "nodepred") != "nodepred":
            raise SystemExit("export currently supports the nodepred "
                             "pipeline (reference dglgo parity scope)")
        if args.checkpoint:
            cfg["checkpoint"] = args.checkpoint
        cfg["device"] = args.device
        with open(args.output, "w") as f:
            f.write(_EXPORT_TEMPLATE.format(
                pipeline=cfg.get("pipeline", "nodepred"), cfg=cfg))
        print(f"standalone script written to {args.output}")
        return

    try:
        if args.cmd == "apply":
            cfg = _read_cfg(args.cfg) if args.cfg else {}
            cfg.setdefault("model", args.model)
            cfg.setdefault("dataset", args.dataset)
            cfg.setdefault("hidden", args.hidden)
            cfg["checkpoint"] = args.checkpoint
            cfg["output"] = args.output
            apply(cfg, args.device)
            return

        if args.cfg:
            cfg = _read_cfg(args.cfg)
        else:
            cfg = {
                "pipeline": args.pipeline or "nodepred",
                "model": args.model,
                "dataset": args.dataset,
            }
        for k in ("epochs", "lr", "hidden"):
            v = getattr(args, k, None)
            if v is not None:
                cfg[k] = v
        train(cfg, args.device)
    except NoCUDA as exc:
        raise SystemExit(f"dgl_tpu_torch {args.cmd}: {exc}")


if __name__ == "__main__":
    main()
