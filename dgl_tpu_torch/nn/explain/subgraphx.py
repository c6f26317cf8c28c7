"""SubgraphX (counterpart of ``dgl_tpu/nn/explain/subgraphx.py``; reference
``python/dgl/nn/pytorch/explain/subgraphx.py``): Monte-Carlo tree search
over connected subgraphs, scored by a Monte-Carlo Shapley value.

The search runs on the host; only the model calls (``_masked_logit``)
touch tensors, on ``feat``'s device. The coalitions come from
``np.random.default_rng(seed)``, as in the JAX package, so equal scores
give equal choices.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch

from ...graph import _asnumpy

__all__ = ["SubgraphX", "MCTSNode"]


class MCTSNode:
    __slots__ = ("nodes", "W", "N", "P", "children")

    def __init__(self, nodes, P=0.0):
        self.nodes = nodes          # frozenset of kept node ids
        self.W = 0.0
        self.N = 0
        self.P = P
        self.children = None


def _ucb_pick(children, coef: float):
    """The child of largest upper confidence bound (the first such)."""
    total_n = max(1, sum(c.N for c in children))

    def ucb(c):
        q = c.W / c.N if c.N else 0.0
        return q + coef * c.P + math.sqrt(total_n) / (1 + c.N)

    return max(children, key=ucb)


def _search(root, num_rollouts, node_max, node_min, coef, score_fn,
            prune_fn):
    """``num_rollouts`` descents from ``root``, each scoring the first
    node of at most ``node_max`` ids it reaches; returns the best such of
    at least ``node_min`` ids and its score (the root and 0.0 if none)."""
    best_nodes, best_score = None, -math.inf

    def rollout(node):
        nonlocal best_nodes, best_score
        if len(node.nodes) <= node_max:
            score = score_fn(node.nodes)
            if len(node.nodes) >= node_min and score > best_score:
                best_score = score
                best_nodes = node.nodes
            node.N += 1
            node.W += score
            return score
        if node.children is None:
            node.children = [MCTSNode(c) for c in prune_fn(node.nodes)]
        if not node.children:
            node.N += 1
            return 0.0
        score = rollout(_ucb_pick(node.children, coef))
        node.N += 1
        node.W += score
        return score

    for _ in range(num_rollouts):
        rollout(root)
    if best_nodes is None:
        return root.nodes, 0.0
    return best_nodes, best_score


def _prune(nodes, deg, high2low: bool):
    """Children: the node set less one of its highest- (or lowest-)
    degree nodes, for the first ``max(4, len // 2)`` of them."""
    cand = sorted(nodes, key=lambda v: deg[v], reverse=high2low)
    out = []
    for v in cand[: max(4, len(cand) // 2)]:
        rest = frozenset(nodes - {v})
        if rest:
            out.append(rest)
    return out


class SubgraphX:
    """(reference ``subgraphx.py:14``).

    ``model_fn(graph, feat) -> logits`` (graph-level). ``explain_graph``
    returns the node ids of the best connected subgraph of size <=
    ``node_max`` and its score.
    """

    def __init__(self, model_fn: Callable, num_hops: int = 2,
                 coef: float = 10.0, high2low: bool = True,
                 num_rollouts: int = 20, node_min: int = 3,
                 shapley_steps: int = 20, seed: int = 0):
        self.model_fn = model_fn
        self.coef = coef
        self.high2low = high2low
        self.num_rollouts = num_rollouts
        self.node_min = node_min
        self.shapley_steps = shapley_steps
        self._rng = np.random.default_rng(seed)

    # -- scoring -------------------------------------------------------------

    @torch.no_grad()
    def _masked_logit(self, g, feat, keep, target):
        mask = np.zeros(g.num_nodes(), np.float32)
        mask[list(keep)] = 1.0
        out = self.model_fn(g, feat * torch.from_numpy(mask).to(
            feat.device)[:, None])
        return float(torch.atleast_2d(out)[0, target])

    def _shapley(self, g, feat, subset, target):
        """Monte-Carlo Shapley value of the subset vs its neighborhood."""
        src, dst = g._relation(None).host_edges()
        sub = set(subset)
        members = np.fromiter(sub, np.int64, len(sub))
        nbrs = set(dst[np.isin(src, members)].tolist())
        nbrs |= set(src[np.isin(dst, members)].tolist())
        region = sorted(nbrs - sub)
        total = 0.0
        for _ in range(self.shapley_steps):
            coal = [x for x in region if self._rng.random() < 0.5]
            with_s = self._masked_logit(g, feat, sub | set(coal), target)
            without = self._masked_logit(g, feat, set(coal), target)
            total += with_s - without
        return total / self.shapley_steps

    # -- search --------------------------------------------------------------

    def _prune_candidates(self, g, nodes):
        """Children: remove one node (keeping the rest), high/low degree
        first; subgraph must stay connected enough (non-empty)."""
        deg = _asnumpy(g.in_degrees()) + _asnumpy(g.out_degrees())
        return _prune(nodes, deg, self.high2low)

    def explain_graph(self, graph, feat, target: Optional[int] = None,
                      node_max: int = 8):
        if target is None:
            with torch.no_grad():
                out = torch.atleast_2d(self.model_fn(graph, feat))
            target = int(torch.argmax(out[0]))
        best_nodes, best_score = _search(
            MCTSNode(frozenset(range(graph.num_nodes()))), self.num_rollouts,
            node_max, self.node_min, self.coef,
            lambda nodes: self._shapley(graph, feat, nodes, target),
            lambda nodes: self._prune_candidates(graph, nodes))
        return np.array(sorted(best_nodes)), best_score


# the JAX package's private name
_MCTSNode = MCTSNode
