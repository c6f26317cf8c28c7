"""Child-Sum Tree-LSTM by topological propagation (counterpart of
``examples/tree_lstm.py``; reference ``examples/pytorch/tree_lstm``): the
UDF + topological-frontier showcase. Each frontier pulls its children's
states through a zero-padded mailbox UDF reduce and applies the gates.

The JAX script compiles its step once over the batched forest; here the
frontiers run eagerly, each a ``pull`` and an ``apply_nodes``.

Run: python -m dgl_tpu_torch.examples.tree_lstm [--epochs 30]
"""
import numpy as np
import torch
from torch import nn

from .. import batch, graph, traversal
from ..nn._init import dense
from ._common import generator, parse, parser

X_SIZE = 16


def random_trees(num_trees, max_nodes, rng, device="cuda"):
    """Random rooted trees, edges child -> parent, each with 16-wide node
    inputs ``x``; drawn from the numpy generator ``rng`` in the JAX
    script's order (a tree's size, its parents, then its inputs)."""
    graphs = []
    for _ in range(num_trees):
        n = int(rng.integers(3, max_nodes))
        parents = [int(rng.integers(0, i)) for i in range(1, n)]
        g = graph((np.arange(1, n), np.array(parents)), num_nodes=n,
                  device=device)
        g.ndata["x"] = torch.from_numpy(
            rng.normal(size=(n, X_SIZE)).astype(np.float32)).to(device)
        graphs.append(g)
    return graphs


class TreeLSTMCell(nn.Module):
    """The child-sum cell over padded mailboxes: ``forward(g, x)`` runs
    the frontiers of ``g`` leaves first and returns every node's h."""

    def __init__(self, x_size, h_size, *, generator=None, device="cuda"):
        super().__init__()
        self.h_size = h_size
        self.W_iou = dense(x_size, 3 * h_size, bias=False,
                           generator=generator)
        self.U_iou = dense(h_size, 3 * h_size, bias=False,
                           generator=generator)
        self.b_iou = nn.Parameter(torch.zeros(3 * h_size))
        self.U_f = dense(h_size, h_size, generator=generator)
        self.to(device)

    def start(self, g, x):
        """A local copy of ``g`` holding the cell's node state: ``iou_x``
        and zero h, c and child sums."""
        g = g.local_var()
        zeros = torch.zeros((g.num_nodes(), self.h_size), device=x.device)
        g.ndata.update({"iou_x": self.W_iou(x), "h": zeros, "c": zeros,
                        "h_sum": zeros, "c_f": zeros})
        return g

    def udfs(self):
        """The message, reduce and apply functions of a frontier, as
        ``pull`` and ``prop_nodes_topo`` take them."""
        def message(edges):
            return {"h": edges.src["h"], "c": edges.src["c"]}

        def reduce(nodes):
            h_child = nodes.mailbox["h"]          # (N, D, H) zero-padded
            mask = nodes.mailbox_mask[..., None]  # (N, D, 1)
            f = torch.sigmoid(self.U_f(h_child))
            return {"h_sum": (h_child * mask).sum(1),
                    "c_f": (f * nodes.mailbox["c"] * mask).sum(1)}

        def apply(nodes):
            iou = (nodes.data["iou_x"] + self.U_iou(nodes.data["h_sum"])
                   + self.b_iou)
            i, o, u = iou.split(self.h_size, dim=-1)
            c = torch.sigmoid(i) * torch.tanh(u) + nodes.data["c_f"]
            return {"h": torch.sigmoid(o) * torch.tanh(c), "c": c}

        return message, reduce, apply

    def forward(self, g, x):
        g = self.start(g, x)
        message, reduce, apply = self.udfs()
        # leaves first: topological frontiers over child -> parent edges
        frontiers = traversal.topological_nodes_generator(g)
        g.apply_nodes(apply, v=np.asarray(frontiers[0]))
        for frontier in frontiers[1:]:
            g.pull(np.asarray(frontier), message, reduce)
            g.apply_nodes(apply, v=np.asarray(frontier))
        return g.ndata["h"]


class Model(nn.Module):
    """The cell (h 32) and a linear head to one output a node."""

    def __init__(self, x_size=X_SIZE, h_size=32, *, generator=None,
                 device="cuda"):
        super().__init__()
        self.cell = TreeLSTMCell(x_size, h_size, generator=generator,
                                 device=device)
        self.head = dense(h_size, 1, generator=generator).to(device)

    def forward(self, g, x):
        return self.head(self.cell(g, x))


def forest_task(device, num_trees=16, max_nodes=12, seed=0):
    """The batched forest, every tree's root (node 0 of each tree) in the
    forest's ids, and the target: each tree's mean input feature."""
    trees = random_trees(num_trees, max_nodes, np.random.default_rng(seed),
                         device)
    forest = batch(trees)
    sizes = np.asarray([t.num_nodes() for t in trees])
    roots = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    y = torch.tensor([float(t.ndata["x"].cpu().numpy().mean())
                      for t in trees], dtype=torch.float32, device=device)
    return forest, torch.from_numpy(roots).to(device), y


def make_model(device, seed=0):
    return Model(generator=generator(seed), device=device)


def loss_fn(model, forest, roots, y):
    pred = model(forest, forest.ndata["x"])[roots, 0]
    return ((pred - y) ** 2).mean()


def main(argv=None):
    p = parser(__doc__)
    p.add_argument("--epochs", type=int, default=30)
    args = parse(p, argv)

    forest, roots, y = forest_task(args.device)
    model = make_model(args.device)
    opt = torch.optim.Adam(model.parameters(), lr=1e-2)

    losses = []
    for epoch in range(args.epochs):
        loss = loss_fn(model, forest, roots, y)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        losses.append(loss.detach())
        if epoch % 10 == 0:
            print(f"epoch {epoch} mse {float(losses[-1]):.4f}")
    print(f"final mse {float(losses[-1]):.4f}")
    return {"losses": torch.stack(losses).tolist()}


if __name__ == "__main__":
    main()
