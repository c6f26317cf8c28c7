"""Graph-classification dataloader (counterpart of
``dgl_tpu/dataloading/graph_loader.py``; reference ``GraphDataLoader``,
``python/dgl/dataloading/dataloader.py:1376``).

With ``pad=True`` (the default) every batch is padded to one shape
(``batch_size + 1`` graphs and fixed node and edge budgets, the slack in
ghost graphs, ``batch.pad_batch``), as the JAX package's loader does.
Yields ``(batched_graph, labels, graph_mask)`` (no labels: ``(batched_graph,
graph_mask)``) on ``device``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..base import DGLError
from ..batch import batch as batch_graphs, pad_batch
from ..graph import _asnumpy

__all__ = ["GraphDataLoader"]


class GraphDataLoader:
    """Iterate a sequence of graphs, or of ``(graph, label)`` pairs, in
    minibatches; the budgets default to ``batch_size`` times the dataset's
    largest graph (plus a node per ghost graph). ``shuffle`` draws from
    the numpy generator made from ``seed``."""

    def __init__(self, dataset, batch_size=1, shuffle=False, drop_last=False,
                 pad=True, num_nodes_budget=None, num_edges_budget=None,
                 seed=None, device="cuda"):
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.pad = pad
        self.device = torch.device(device)
        self._rng = np.random.default_rng(seed)
        if self.batch_size < 1:
            raise DGLError("batch_size must be >= 1")
        item = dataset[0]
        self._has_labels = isinstance(item, (tuple, list)) and len(item) == 2
        if pad:
            if num_nodes_budget is None or num_edges_budget is None:
                max_n = max_e = 0
                for item in dataset:
                    g = item[0] if self._has_labels else item
                    max_n = max(max_n, g.num_nodes())
                    max_e = max(max_e, g.num_edges())
                if num_nodes_budget is None:
                    num_nodes_budget = (self.batch_size * max_n
                                        + self.batch_size + 1)
                if num_edges_budget is None:
                    num_edges_budget = self.batch_size * max_e
            self.num_nodes_budget = int(num_nodes_budget)
            self.num_edges_budget = int(num_edges_budget)

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def __iter__(self):
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            self._rng.shuffle(order)
        bs = self.batch_size
        for lo in range(0, n, bs):
            idx = order[lo:lo + bs]
            if idx.shape[0] < bs and self.drop_last:
                return
            items = [self.dataset[int(i)] for i in idx]
            if self._has_labels:
                graphs = [g.to(self.device) for g, _ in items]
                labels = np.asarray([_asnumpy(lab) for _, lab in items])
            else:
                graphs = [g.to(self.device) for g in items]
                labels = None
            if self.pad:
                bg, gmask = pad_batch(graphs, bs + 1, self.num_nodes_budget,
                                      self.num_edges_budget)
                if labels is not None:
                    lab = np.zeros((bs + 1,) + labels.shape[1:],
                                   labels.dtype)
                    lab[:labels.shape[0]] = labels
                    labels = lab
            else:
                bg = batch_graphs(graphs)
                gmask = torch.ones(len(graphs), dtype=torch.bool,
                                   device=self.device)
            if labels is None:
                yield bg, gmask
            else:
                yield bg, torch.from_numpy(labels).to(self.device), gmask
