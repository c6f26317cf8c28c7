"""E(n)-equivariant graph conv (counterpart of
``dgl_tpu/nn/conv/egnnconv.py``; reference
``python/dgl/nn/pytorch/conv/egnnconv.py``): messages from invariant
squared distances (an edge UDF), summed for the features and averaged for
the coordinates (``copy_e`` g-SpMMs); coordinates update equivariantly."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ... import function as fn
from .._init import dense

__all__ = ["EGNNConv"]


class EGNNConv(nn.Module):
    """(reference ``egnnconv.py:10``). ``edge_mlp0``/``edge_mlp1``,
    ``node_mlp0``/``node_mlp1``, ``coord_mlp0`` and ``coord_mlp1`` (no
    bias): ``nn.Linear`` drawn as flax's ``Dense`` default, SiLU between.
    ``forward(graph, node_feat, coord_feat, edge_feat=None)`` returns
    ``(h', x')``."""

    def __init__(self, in_size: int, hidden_size: int, out_size: int,
                 edge_feat_size: int = 0, *,
                 generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        self.edge_feat_size = edge_feat_size
        kw = dict(generator=generator)
        self.edge_mlp0 = dense(2 * in_size + 1 + edge_feat_size,
                               hidden_size, **kw)
        self.edge_mlp1 = dense(hidden_size, hidden_size, **kw)
        self.node_mlp0 = dense(in_size + hidden_size, hidden_size, **kw)
        self.node_mlp1 = dense(hidden_size, out_size, **kw)
        self.coord_mlp0 = dense(hidden_size, hidden_size, **kw)
        self.coord_mlp1 = dense(hidden_size, 1, False, **kw)
        self.to(device)

    def forward(self, graph, node_feat, coord_feat, edge_feat=None):
        act = torch.nn.functional.silu
        with graph.local_scope() as g:
            g.ndata["h"] = node_feat
            g.ndata["x"] = coord_feat
            if self.edge_feat_size > 0:
                if edge_feat is None:
                    raise ValueError("edge_feat required")
                g.edata["a"] = edge_feat

            def message(edges):
                diff = edges.src["x"] - edges.dst["x"]
                radial = (diff * diff).sum(-1, keepdim=True)
                parts = [edges.src["h"], edges.dst["h"], radial]
                if self.edge_feat_size > 0:
                    parts.append(edges.data["a"])
                f = act(self.edge_mlp1(act(self.edge_mlp0(
                    torch.cat(parts, -1)))))
                w = self.coord_mlp1(act(self.coord_mlp0(f)))
                return {"msg_h": f, "msg_x": diff * w}

            g.apply_edges(message)
            g.update_all(fn.copy_e("msg_h", "m"), fn.sum("m", "h_neigh"))
            g.update_all(fn.copy_e("msg_x", "m"), fn.mean("m", "x_neigh"))
            h_neigh, x_neigh = g.ndata["h_neigh"], g.ndata["x_neigh"]
            h = self.node_mlp1(act(self.node_mlp0(
                torch.cat([node_feat, h_neigh], -1))))
            return h, coord_feat + x_neigh
