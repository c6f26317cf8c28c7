"""Gated graph convolution, GGNN (counterpart of
``dgl_tpu/nn/conv/gatedgraphconv.py``; reference
``python/dgl/nn/pytorch/conv/gatedgraphconv.py``): per step, each edge's
message is its source row times its edge type's weight
(``ops.gather_mm``), summed by ``update_all(copy_e, sum)``, then a GRU
cell updates every node."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ... import function as fn
from ...base import DGLError
from ...ops import gather_mm
from .._init import flax_init
from ..utils_nn import pad_edges

__all__ = ["GatedGraphConv"]


class GatedGraphConv(nn.Module):
    """GGNN layer (reference ``gatedgraphconv.py:13``).

    ``weight`` (n_etypes, out, out), Xavier-uniform; ``gru``, a
    ``torch.nn.GRUCell(out, out)`` whose gates equal flax's ``GRUCell``
    (``from_flax_params`` stacks flax's ``ir``/``iz``/``in`` and
    ``hr``/``hz``/``hn`` into it; flax has no ``hr`` and ``hz`` bias, so
    ``bias_hh``'s r and z parts start at 0 and get no gradient).
    ``forward(graph, feat, etypes=None)``: ``etypes`` (E,) edge type ids,
    all 0 when not given; inputs narrower than ``out_feats`` are padded
    with zero columns. Padded edges (source the virtual row ``num_src``)
    send no message: the reference's clamped gather reads the last row
    there, whose message no real destination receives either way."""

    def __init__(self, in_feats: int, out_feats: int, n_steps: int,
                 n_etypes: int = 1, *,
                 generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        if in_feats > out_feats:
            raise DGLError(f"in_feats ({in_feats}) must not exceed "
                           f"out_feats ({out_feats})")
        self.in_feats, self.out_feats = in_feats, out_feats
        self.n_steps = n_steps
        self.weight = nn.Parameter(flax_init(
            "xavier_uniform", (n_etypes, out_feats, out_feats), generator))
        self.gru = nn.GRUCell(out_feats, out_feats)
        with torch.no_grad():
            # flax's GRUCell: LeCun-normal input kernels, orthogonal
            # recurrent kernels, zero biases; one (out, out) block a gate
            for w in self.gru.weight_ih.split(out_feats):
                w.copy_(flax_init("lecun_normal", (out_feats, out_feats),
                                  generator).T)
            for w in self.gru.weight_hh.split(out_feats):
                nn.init.orthogonal_(w, generator=generator)
            self.gru.bias_ih.zero_()
            self.gru.bias_hh.zero_()
        self.to(device)
        # flax's GRUCell has no bias on hr and hz: their parts of bias_hh
        # stay 0, their gradient zeroed
        keep = torch.ones(3 * out_feats, device=self.gru.bias_hh.device)
        keep[:2 * out_feats] = 0
        self.gru.bias_hh.register_hook(lambda grad: grad * keep)

    def forward(self, graph, feat, etypes=None):
        with graph.local_scope() as g:
            rel = g._relation()
            E = rel.num_edges
            if etypes is None:
                etypes = torch.zeros(E, dtype=torch.int64,
                                     device=feat.device)
            et = etypes[:E].to(torch.int64)
            src = rel.src[:E].to(torch.int64)
            h = feat
            if self.out_feats > self.in_feats:
                h = torch.cat([feat, feat.new_zeros(
                    feat.shape[:-1] + (self.out_feats - self.in_feats,))],
                    -1)
            for _ in range(self.n_steps):
                m = gather_mm(h.index_select(0, src), self.weight, et)
                g.edata["m"] = pad_edges(m, rel)
                g.update_all(fn.copy_e("m", "m"), fn.sum("m", "a"))
                h = self.gru(g.dstdata["a"], h)
            return h
