"""GraphSAGE convolution (counterpart of ``dgl_tpu/nn/conv/sageconv.py``).

Reference: ``python/dgl/nn/pytorch/conv/sageconv.py``. Separate self and
neighbour projections; for ``mean`` and ``gcn`` the neighbour projection
runs before the message passing when it narrows the features
(``in_feats > out_feats``), so the aggregation runs at the smaller width.
Aggregators: ``mean`` and ``gcn`` (``copy_u`` sums, through a hub plan's
kernel where the graph has one), ``pool`` (``relu(fc_pool(h))``, then a
max) and ``lstm`` (an LSTM over each node's mailbox).
``precompute_sage_neigh`` and ``SAGEConv(precomputed_neigh=...)`` take the
mean aggregation of a constant input table out of the training loop.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from ... import function as fn
from ...base import DGLError
from .._init import flax_init
from .graphconv import expand_as_pair

_AGGREGATORS = ("mean", "gcn", "pool", "lstm")


def precompute_sage_neigh(graph, feat, edge_weight=None):
    """The mean-aggregated neighbourhood of a constant input table, for
    ``SAGEConv(..., precomputed_neigh=...)`` with the mean aggregator: the
    aggregation is linear, so ``fc_neigh(mean_agg(X))`` equals
    ``fc_neigh`` of this table and the layer's g-SpMM (forward and
    backward) leaves the epoch. The mean of ``copy_u``, or of ``u_mul_e``
    when ``edge_weight`` is given."""
    with graph.local_scope() as g:
        msg_fn = fn.copy_u("h", "m")
        if edge_weight is not None:
            g.edata["_edge_weight"] = edge_weight
            msg_fn = fn.u_mul_e("h", "_edge_weight", "m")
        g.srcdata["h"] = feat
        g.update_all(msg_fn, fn.mean("m", "neigh"))
        return g.dstdata["neigh"]


def _lstm_reduce(cell, m, mask):
    """The LSTM over a padded mailbox ``m`` (N, D, F) whose real slots
    ``mask`` (N, D) marks, the carry frozen past a node's last message, as
    the reference's masked scan: the final ``h`` (N, F), 0 for a node
    without messages. ``cell`` (a ``torch.nn.LSTMCell``) holds the
    weights; the step is written out (gates i, f, g, o, as torch's and
    flax's).

    The real slots come first in each row, so step ``t`` moves only the
    nodes of in-degree above ``t``. The nodes run sorted by in-degree,
    largest first, which makes them a prefix of the carry at every step:
    each step computes that prefix alone (``E`` rows over all steps, not
    ``N * D``), and the rows that take their last message are kept as
    they finish. One gather and one product take every step's input rows
    and their input projections, split into views (a gather a step would
    give each step's backward a gradient of the whole mailbox). The step
    keeps 8 floats a feature a row for the backward, where the fused
    ``LSTMCell`` keeps 16 (its gates twice over). The prefix lengths take
    one host read of the degree counts."""
    n, d = mask.shape[:2]
    feats = cell.hidden_size
    deg = mask.sum(1)
    order = torch.argsort(deg, descending=True, stable=True)
    counts = torch.bincount(deg, minlength=d + 1)
    # active[t]: the nodes with more than t messages (one host read)
    active = [a for a in (n - torch.cumsum(counts, 0)[:d]).tolist() if a]
    finished = []  # the rows that took their last message, step by step
    if active:
        rows = order * d
        flat = m.reshape((n * d,) + tuple(m.shape[2:]))
        x = flat.index_select(0, torch.cat(
            [rows[:a] + t for t, a in enumerate(active)]))
        gates_in = torch.nn.functional.linear(x, cell.weight_ih,
                                              cell.bias_ih + cell.bias_hh)
        h = c = m.new_zeros((active[0], feats))
        w_hh = cell.weight_hh.t()
        for gi, nxt in zip(torch.split(gates_in, active), active[1:] + [0]):
            i, f, g, o = torch.addmm(gi, h, w_hh).chunk(4, 1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            finished.append(h[nxt:])
            h, c = h[:nxt], c[:nxt]
    # sorted order: the largest in-degree (the last to finish) first, the
    # nodes without messages (carry 0) last
    h_sorted = torch.cat(finished[::-1] + [m.new_zeros(
        (n - (active[0] if active else 0), feats))])
    return h_sorted.new_empty(h_sorted.shape).index_copy(0, order, h_sorted)


class SAGEConv(nn.Module):
    """GraphSAGE layer (reference ``sageconv.py:13``).

    Parameters are initialised on the CPU from ``generator`` (Xavier-uniform
    projections, zero bias), as the reference's flax module initialises
    them, and the module is then moved to ``device``. ``gcn`` has no
    ``fc_self``; ``pool`` adds ``fc_pool`` (in, in) with a bias; ``lstm``
    adds ``lstm``, a ``torch.nn.LSTMCell(in, in)`` holding flax's
    ``OptimizedLSTMCell`` (LeCun-normal input kernels, orthogonal
    recurrent kernels, zero biases; flax's input projections have no
    bias, so ``bias_ih`` stays 0: a gradient hook zeroes its gradient).
    """

    def __init__(self, in_feats: int, out_feats: int,
                 aggregator_type: str = "mean", feat_drop: float = 0.0,
                 bias: bool = True, norm: Optional[Callable] = None,
                 activation: Optional[Callable] = None, *,
                 generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        if aggregator_type not in _AGGREGATORS:
            raise DGLError(f"Invalid aggregator_type {aggregator_type!r}")
        self.in_feats = in_feats
        self.out_feats = out_feats
        self.aggregator_type = aggregator_type
        self.feat_drop = nn.Dropout(feat_drop)
        self.norm = norm
        self.activation = activation
        self.fc_neigh = nn.Linear(in_feats, out_feats, bias=False)
        self.fc_self = (None if aggregator_type == "gcn"
                        else nn.Linear(in_feats, out_feats, bias=False))
        self.bias = nn.Parameter(torch.zeros(out_feats)) if bias else None
        with torch.no_grad():
            nn.init.xavier_uniform_(self.fc_neigh.weight, generator=generator)
            if self.fc_self is not None:
                nn.init.xavier_uniform_(self.fc_self.weight,
                                        generator=generator)
        if aggregator_type == "pool":
            self.fc_pool = nn.Linear(in_feats, in_feats)
            with torch.no_grad():
                nn.init.xavier_uniform_(self.fc_pool.weight,
                                        generator=generator)
                self.fc_pool.bias.zero_()
        if aggregator_type == "lstm":
            self.lstm = nn.LSTMCell(in_feats, in_feats)
            with torch.no_grad():
                for w in self.lstm.weight_ih.split(in_feats):
                    w.copy_(flax_init("lecun_normal", (in_feats, in_feats),
                                      generator).T)
                for w in self.lstm.weight_hh.split(in_feats):
                    nn.init.orthogonal_(w, generator=generator)
                self.lstm.bias_ih.zero_()
                self.lstm.bias_hh.zero_()
        self.to(device)
        if aggregator_type == "lstm":
            self.lstm.bias_ih.register_hook(torch.zeros_like)

    def forward(self, graph, feat, edge_weight=None, precomputed_neigh=None):
        if precomputed_neigh is not None:
            # as the reference's branch: no dropout, no message passing
            if self.aggregator_type != "mean":
                raise DGLError(
                    "precomputed_neigh requires the mean aggregator")
            _feat_src, feat_dst = expand_as_pair(feat, graph)
            return self._finish(self.fc_self(feat_dst)
                                + self.fc_neigh(precomputed_neigh))
        with graph.local_scope() as g:
            feat_src, feat_dst = expand_as_pair(feat, g)
            feat_src = self.feat_drop(feat_src)
            feat_dst = self.feat_drop(feat_dst)
            msg_fn = fn.copy_u("h", "m")
            if edge_weight is not None:
                g.edata["_edge_weight"] = edge_weight
                msg_fn = fn.u_mul_e("h", "_edge_weight", "m")
            lin_before_mp = self.in_feats > self.out_feats
            agg = self.aggregator_type
            if agg in ("mean", "gcn"):
                g.srcdata["h"] = (self.fc_neigh(feat_src) if lin_before_mp
                                  else feat_src)
                if agg == "mean":
                    g.update_all(msg_fn, fn.mean("m", "neigh"))
                    h_neigh = g.dstdata["neigh"]
                else:
                    h_self = g.srcdata["h"][:g.num_dst_nodes()]
                    g.update_all(msg_fn, fn.sum("m", "neigh"))
                    degs = g.in_degrees().to(feat_dst.dtype)
                    h_neigh = (g.dstdata["neigh"] + h_self) / (
                        degs.unsqueeze(-1) + 1)
                if not lin_before_mp:
                    h_neigh = self.fc_neigh(h_neigh)
            elif agg == "pool":
                g.srcdata["h"] = torch.relu(self.fc_pool(feat_src))
                g.update_all(msg_fn, fn.max("m", "neigh"))
                h_neigh = self.fc_neigh(g.dstdata["neigh"])
            else:
                g.srcdata["h"] = feat_src

                def reducer(nodes):
                    return {"neigh": _lstm_reduce(
                        self.lstm, nodes.mailbox["m"], nodes.mailbox_mask)}

                g.update_all(msg_fn, reducer)
                h_neigh = self.fc_neigh(g.dstdata["neigh"])
            rst = h_neigh if self.fc_self is None else (
                self.fc_self(feat_dst) + h_neigh)
            return self._finish(rst)

    def _finish(self, rst):
        if self.bias is not None:
            rst = rst + self.bias
        if self.activation is not None:
            rst = self.activation(rst)
        if self.norm is not None:
            rst = self.norm(rst)
        return rst
