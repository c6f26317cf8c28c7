"""Edge-augmented Graph Transformer layer (counterpart of
``dgl_tpu/nn/gt/egt.py``; reference ``python/dgl/nn/pytorch/gt/egt.py``):
node and edge (pair) channels update each other through gated
attention."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .._init import dense

__all__ = ["EGTLayer"]


class EGTLayer(nn.Module):
    """(reference ``egt.py:12``). Layer norms ``mha_ln_h``, ``mha_ln_e``,
    ``ffn_ln_h``, ``ffn_ln_e`` (flax's epsilon 1e-6); ``qkv_proj``,
    ``e_bias``, ``e_gate``, ``mha_out``, ``ffn_h0``/``ffn_h1`` (ELU
    between) and, with ``edge_update``, ``e_out``, ``ffn_e0``/``ffn_e1``:
    ``nn.Linear`` drawn as flax's ``Dense`` default.

    ``forward(nfeat, efeat, mask=None)``: ``nfeat`` (B, N, D), ``efeat``
    (B, N, N, De), ``mask`` (B, N, N) added to the scores. Returns
    ``(nfeat, efeat)``, or ``nfeat`` without ``edge_update``.
    ``num_virtual_nodes`` and ``activation`` are kept for the reference's
    signature; the reference applies ELU."""

    def __init__(self, feat_size: int, edge_feat_size: int, num_heads: int,
                 num_virtual_nodes: int = 0, dropout: float = 0.0,
                 attn_dropout: float = 0.0, activation=None,
                 edge_update: bool = True, *,
                 generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        self.feat_size, self.num_heads = feat_size, num_heads
        self.edge_update = edge_update
        F, FE, H = feat_size, edge_feat_size, num_heads
        kw = dict(generator=generator)
        self.mha_ln_h = nn.LayerNorm(F, eps=1e-6)
        self.mha_ln_e = nn.LayerNorm(FE, eps=1e-6)
        self.qkv_proj = dense(F, 3 * F, **kw)
        self.e_bias = dense(FE, H, **kw)
        self.e_gate = dense(FE, H, **kw)
        self.mha_out = dense(F, F, **kw)
        self.ffn_ln_h = nn.LayerNorm(F, eps=1e-6)
        self.ffn_h0 = dense(F, 2 * F, **kw)
        self.ffn_h1 = dense(2 * F, F, **kw)
        if edge_update:
            self.e_out = dense(H, FE, **kw)
            self.ffn_ln_e = nn.LayerNorm(FE, eps=1e-6)
            self.ffn_e0 = dense(FE, 2 * FE, **kw)
            self.ffn_e1 = dense(2 * FE, FE, **kw)
        self.dropout = nn.Dropout(dropout)
        self.attn_dropout = nn.Dropout(attn_dropout)
        self.to(device)

    def forward(self, nfeat, efeat, mask=None):
        elu = torch.nn.functional.elu
        H = self.num_heads
        D = self.feat_size // H
        B, N = nfeat.shape[0], nfeat.shape[1]
        norm_e = self.mha_ln_e(efeat)
        q, k, v = torch.chunk(self.qkv_proj(self.mha_ln_h(nfeat)), 3, -1)
        e_bias = self.e_bias(norm_e)  # (B, N, N, H)
        gates = self.e_gate(norm_e)
        q, k, v = (t.reshape(B, N, H, D) for t in (q, k, v))
        attn_hat = torch.einsum("bnhd,bmhd->bnmh", q, k) / D ** 0.5
        attn_hat = attn_hat + e_bias
        if mask is not None:
            attn_hat = attn_hat + mask.unsqueeze(-1)
        attn = torch.softmax(attn_hat, 2) * torch.sigmoid(gates)
        attn = self.attn_dropout(attn)
        out = torch.einsum("bnmh,bmhd->bnhd", attn, v).reshape(
            B, N, self.feat_size)
        nfeat = nfeat + self.dropout(self.mha_out(out))
        h = self.ffn_h1(elu(self.ffn_h0(self.ffn_ln_h(nfeat))))
        nfeat = nfeat + self.dropout(h)
        if not self.edge_update:
            return nfeat
        efeat = efeat + self.dropout(self.e_out(attn_hat))
        e = self.ffn_e1(elu(self.ffn_e0(self.ffn_ln_e(efeat))))
        return nfeat, efeat + self.dropout(e)
