"""GraphSAGE over on-device fixed-shape MFGs (counterpart of
``dgl_tpu/models/device_sage.py``).

The math of ``SAGEConv`` with the mean aggregator,
``h = fc_self(h_dst) + fc_neigh(masked_mean(h_nbrs)) + bias``, where the
neighbour mean is a reshape of the fixed-fanout frontier in place of a
g-SpMM: a :class:`~dgl_tpu_torch.sampling.DeviceMFG` lays out each
frontier as the previous one followed by its picks.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

__all__ = ["DeviceSAGE"]


class DeviceSAGE(nn.Module):
    """Multi-layer mean-aggregator GraphSAGE on a ``DeviceMFG``.

    ``forward(mfg, x)`` takes the features of ``mfg.input_nodes()`` and
    returns per-seed logits, aligned with ``mfg.frontiers[0]``. Layer
    ``l`` holds ``sage{l}_fc_neigh`` and ``sage{l}_fc_self`` (bias-free,
    Xavier-uniform from ``generator``, drawn on the CPU in that order) and
    ``sage{l}_bias`` (zeros), the reference's parameter names, so
    :func:`dgl_tpu_torch.params.from_flax_params` maps its tree. ReLU and
    dropout run between layers.
    """

    def __init__(self, in_feats: int, hidden_feats: int, num_classes: int,
                 num_layers: int = 2, dropout: float = 0.0, *,
                 generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        self.num_layers = num_layers
        dims = [in_feats] + [hidden_feats] * (num_layers - 1) + [num_classes]
        for i in range(num_layers):
            for side in ("neigh", "self"):
                fc = nn.Linear(dims[i], dims[i + 1], bias=False)
                with torch.no_grad():
                    nn.init.xavier_uniform_(fc.weight, generator=generator)
                self.add_module(f"sage{i}_fc_{side}", fc)
            self.register_parameter(f"sage{i}_bias",
                                    nn.Parameter(torch.zeros(dims[i + 1])))
        self.dropout = nn.Dropout(dropout)
        self.to(device)

    def forward(self, mfg, x):
        L = mfg.num_layers
        if L != self.num_layers:
            raise ValueError(f"MFG has {L} layers but the model expects "
                             f"{self.num_layers}")
        h = x
        # depth L - 1 (the innermost frontier) runs layer 0
        for depth in range(L - 1, -1, -1):
            layer = L - 1 - depth
            num = mfg.frontiers[depth].shape[0]
            fanout = mfg.nbrs[depth].shape[1]
            h_self = h[:num]
            h_nbr = h[num:num + num * fanout].reshape(num, fanout, -1)
            m = mfg.masks[depth].to(h.dtype)[..., None]
            mean = (h_nbr * m).sum(1) / torch.clamp(m.sum(1), min=1.0)
            h = (getattr(self, f"sage{layer}_fc_self")(h_self)
                 + getattr(self, f"sage{layer}_fc_neigh")(mean))
            h = h + getattr(self, f"sage{layer}_bias")
            if layer != self.num_layers - 1:
                h = torch.relu(h)
                if self.dropout.p > 0:
                    h = self.dropout(h)
        return h
