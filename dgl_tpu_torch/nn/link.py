"""Link prediction scorers (counterpart of ``dgl_tpu/nn/link.py``;
reference ``python/dgl/nn/pytorch/link/``: ``edgepred.py``,
``transe.py``, ``transr.py``)."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ._init import dense, embed

__all__ = ["EdgePredictor", "TransE", "TransR"]


class EdgePredictor(nn.Module):
    """Pairwise scorer of (src, dst) representations (reference
    ``edgepred.py:10``): ``op`` ``"dot"`` or ``"cos"`` (a (B, 1) score),
    ``"ele"`` (the product) or ``"cat"`` (the concatenation), then with
    ``out_feats`` ``lin``, an ``nn.Linear`` (flax's ``Dense`` default,
    bias with ``bias``) from that width (``in_feats`` needed for ``ele``
    and ``cat``)."""

    def __init__(self, op: str = "dot", in_feats: Optional[int] = None,
                 out_feats: Optional[int] = None, bias: bool = False, *,
                 generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        if op not in ("dot", "cos", "ele", "cat"):
            raise ValueError(f"Unknown op {op!r}")
        self.op = op
        self.lin = None
        if out_feats is not None:
            width = {"dot": 1, "cos": 1, "ele": in_feats,
                     "cat": 2 * in_feats if in_feats else None}[op]
            if width is None:
                raise ValueError(f"op {op!r} with out_feats needs in_feats")
            self.lin = dense(width, out_feats, bias, generator=generator)
        self.to(device)

    def forward(self, h_src, h_dst):
        if self.op == "dot":
            out = (h_src * h_dst).sum(-1, keepdim=True)
        elif self.op == "cos":
            s = h_src / (torch.linalg.vector_norm(h_src, dim=-1,
                                                  keepdim=True) + 1e-12)
            d = h_dst / (torch.linalg.vector_norm(h_dst, dim=-1,
                                                  keepdim=True) + 1e-12)
            out = (s * d).sum(-1, keepdim=True)
        elif self.op == "ele":
            out = h_src * h_dst
        else:
            out = torch.cat([h_src, h_dst], -1)
        return out if self.lin is None else self.lin(out)


def _score(diff, p):
    if p == 1:
        return -torch.abs(diff).sum(-1)
    return -torch.sqrt((diff * diff).sum(-1) + 1e-12)


class TransE(nn.Module):
    """TransE scorer ``-||h + r - t||_p``, ``p`` 1 or 2 (reference
    ``transe.py:8``). ``rel_emb`` (num_rels, feats), flax's ``Embed``
    draw. ``forward(h_head, h_tail, rels)``."""

    def __init__(self, num_rels: int, feats: int, p: int = 1, *,
                 generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        self.p = p
        self.rel_emb = embed(num_rels, feats, generator)
        self.to(device)

    def forward(self, h_head, h_tail, rels):
        return _score(h_head + self.rel_emb(rels) - h_tail, self.p)


class TransR(nn.Module):
    """TransR scorer (reference ``transr.py:8``): head and tail projected
    into the relation's space by its (nfeats, rfeats) matrix, then
    TransE. ``rel_emb`` (num_rels, rfeats) and ``rel_project``
    (num_rels, rfeats * nfeats): flax's ``Embed`` draws.
    ``forward(h_head, h_tail, rels)``."""

    def __init__(self, num_rels: int, rfeats: int, nfeats: int, p: int = 1,
                 *, generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        self.rfeats, self.nfeats, self.p = rfeats, nfeats, p
        self.rel_emb = embed(num_rels, rfeats, generator)
        self.rel_project = embed(num_rels, rfeats * nfeats, generator)
        self.to(device)

    def forward(self, h_head, h_tail, rels):
        proj = self.rel_project(rels).reshape(-1, self.nfeats, self.rfeats)
        hh = torch.einsum("ed,edr->er", h_head, proj)
        ht = torch.einsum("ed,edr->er", h_tail, proj)
        return _score(hh + self.rel_emb(rels) - ht, self.p)
