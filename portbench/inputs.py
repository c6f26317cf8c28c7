"""The general generator: every input of a run, made from ``--seed``.

One ``torch.Generator`` on the run's device draws, in a fixed order for
each graph kind, the graph (its edge lists by relation), the labels, the
node features and the train mask, then the weights, then the seed of the
dropout masks. The same
seed gives the same tensors, so the program gets them once and the
reference, after the window, gets them again from the same call. Every
seed gives the same sizes: only the ids and values change.

Graph kinds (the configuration's ``graph``, with the mix's overrides):

- ``zipf``: ``nodes`` nodes and ``edges`` drawn edges, sources drawn with
  P(node i) proportional to (i + 1) ** -``src_zipf_s`` and destinations
  uniformly (``bench.py:178-183``'s arxiv-scale graph at s = 1; s = 0 is
  the uniform control of ``bench.py``), ``classes`` uniform labels,
  ``feat`` features that are Gaussian class centroids times ``centroids``
  plus unit noise (the typed recipe's; without ``centroids``, unit noise
  alone) and a train mask of ``train_nodes`` nodes.
  With ``symmetric`` the graph holds each drawn edge both ways (2 x
  ``edges`` edges), as a script that trains on the symmetrised adjacency
  sees it. With ``even_degrees`` (in place of the zipf draw) every node
  is the source of ``edges // nodes`` or one more drawn edges, and the
  destination of as many, paired at random: a near-regular graph, as kNN
  and mesh graphs are, whose degrees are the same for every seed;
- ``typed``: the ogbn-mag-shaped recipe of
  ``dgl_tpu/data/synthetic.py:324-395`` (node counts by type, edge counts
  by relation; the ``homophilous`` relation sends ``homophily`` of its
  edges to a node of the source's class, the rest uniformly; other
  relations uniform at both ends; the ``target`` type's features are
  Gaussian class centroids times 2 plus unit noise, the others' unit
  noise; a ``train_share`` of the target nodes trains). A relation named
  in ``symmetric`` holds each drawn edge both ways; one named in
  ``reverse`` gains a relation of that name with every edge reversed,
  after the drawn relations.

Mirrored and reversed edges are copies, not draws: the graph's sizes are
fixed by the configuration, whatever the seed.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

HOMOGENEOUS = ("_N", "_E", "_N")


@dataclass
class Inputs:
    """Edge lists ``(src, dst)`` (int64) by canonical relation, node counts
    by type, features by type, and the labels and float train mask of the
    ``target`` type."""
    relations: dict
    num_nodes: dict
    feats: dict
    labels: torch.Tensor
    train_mask: torch.Tensor
    target: str

    def edge_counts(self) -> dict:
        return {cet: int(s.shape[0])
                for cet, (s, _d) in self.relations.items()}


def relations(graph: dict) -> list:
    """The canonical relations of a ``typed`` graph, in the order the
    generator makes them: the drawn ones, then the reversed ones."""
    drawn = [tuple(r[:3]) for r in graph["relations"]]
    rev = graph.get("reverse", {})
    return drawn + [(dt, rev[et], st) for st, et, dt in drawn if et in rev]


def _both_ways(src, dst):
    return torch.cat([src, dst]), torch.cat([dst, src])


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed % 2**64)


def _zipf(g: dict, gen, device) -> Inputs:
    n, e = int(g["nodes"]), int(g["edges"])
    if g.get("even_degrees"):
        ids = torch.arange(e, device=device) % n
        src = ids[torch.randperm(e, device=device, generator=gen)]
        dst = ids[torch.randperm(e, device=device, generator=gen)]
    else:
        w = torch.arange(1, n + 1, dtype=torch.float64, device=device).pow(
            -float(g["src_zipf_s"]))
        cdf = torch.cumsum(w, 0)
        cdf /= cdf[-1].clone()
        u = torch.rand(e, dtype=torch.float64, device=device, generator=gen)
        src = torch.searchsorted(cdf, u, right=True).clamp_(max=n - 1)
        dst = torch.randint(0, n, (e,), device=device, generator=gen)
    if g.get("symmetric"):
        src, dst = _both_ways(src, dst)
    classes, feat = int(g["classes"]), int(g["feat"])
    labels = torch.randint(0, classes, (n,), device=device, generator=gen)
    centroids = torch.randn((classes, feat), device=device,
                            generator=gen) * float(g.get("centroids", 0.0))
    feats = centroids[labels] + torch.randn((n, feat), device=device,
                                            generator=gen)
    mask = torch.zeros(n, device=device)
    mask[torch.randperm(n, device=device, generator=gen)[
        :int(g["train_nodes"])]] = 1.0
    return Inputs({HOMOGENEOUS: (src, dst)}, {"_N": n}, {"_N": feats},
                  labels, mask, "_N")


def _typed(g: dict, gen, device) -> Inputs:
    nodes = {nt: int(n) for nt, n in g["nodes"].items()}
    target, classes = g["target"], int(g["classes"])
    n_t = nodes[target]
    labels = torch.randint(0, classes, (n_t,), device=device, generator=gen)
    order = torch.sort(labels, stable=True).indices
    starts = torch.searchsorted(labels[order],
                                torch.arange(classes + 1, device=device))
    rels = {}
    for st, et, dt, ne in g["relations"]:
        src = torch.randint(0, nodes[st], (ne,), device=device, generator=gen)
        if et == g.get("homophilous"):
            # every class a source has is non-empty: it holds the source
            c = labels[src]
            lo, hi = starts[c], starts[c + 1]
            pick = order[lo + (torch.rand(ne, device=device, generator=gen)
                               * (hi - lo)).long()]
            near = torch.rand(ne, device=device, generator=gen) < float(
                g["homophily"])
            dst = torch.where(near, pick, torch.randint(
                0, nodes[dt], (ne,), device=device, generator=gen))
        else:
            dst = torch.randint(0, nodes[dt], (ne,), device=device,
                                generator=gen)
        if et in g.get("symmetric", ()):
            src, dst = _both_ways(src, dst)
        rels[(st, et, dt)] = (src, dst)
    rev = g.get("reverse", {})
    for (st, et, dt), (src, dst) in list(rels.items()):
        if et in rev:
            rels[(dt, rev[et], st)] = (dst, src)
    feat = int(g["feat"])
    centroids = torch.randn((classes, feat), device=device, generator=gen) * 2
    feats = {target: centroids[labels] + torch.randn(
        (n_t, feat), device=device, generator=gen)}
    for nt, n in nodes.items():
        if nt != target:
            feats[nt] = torch.randn((n, feat), device=device, generator=gen)
    mask = torch.zeros(n_t, device=device)
    mask[torch.randperm(n_t, device=device, generator=gen)[
        :int(n_t * float(g["train_share"]))]] = 1.0
    return Inputs(rels, nodes, feats, labels, mask, target)


KINDS = {"zipf": _zipf, "typed": _typed}


def make_weights(shapes: dict, gen, device) -> dict:
    """The weights of ``shapes`` (name -> ``(shape, bound)``) in one draw:
    uniform in (-bound, bound), float32, on the device."""
    total = sum(torch.Size(s).numel() for s, _b in shapes.values())
    flat = torch.rand(total, device=device, generator=gen) * 2 - 1
    out, at = {}, 0
    for name, (shape, bound) in shapes.items():
        k = torch.Size(shape).numel()
        out[name] = (flat[at:at + k] * bound).reshape(shape).contiguous()
        at += k
    return out


def make(graph: dict, shapes: dict, seed: int, device):
    """``(inputs, weights, dropout_seed)`` of one run; ``shapes`` are the
    weights' (the reference family's ``param_shapes``)."""
    gen = generator(seed, device)
    inputs = KINDS[graph["kind"]](graph, gen, device)
    weights = make_weights(shapes, gen, device)
    dropout_seed = int(torch.randint(0, 2**62, (1,), device=device,
                                     generator=gen).item())
    return inputs, weights, dropout_seed
