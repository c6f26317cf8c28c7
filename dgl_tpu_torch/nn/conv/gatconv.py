"""Graph attention layer (counterpart of ``dgl_tpu/nn/conv/gatconv.py``).

Reference: ``python/dgl/nn/pytorch/conv/gatconv.py``. The layer picks one
of four routes for the attention, in the reference's order
(``dgl_tpu/nn/conv/gatconv.py:66-161``); the first three need no edge
weight and no returned attention:

1. dense masked attention (``ops/dense_attn.py``) when the relation
   carries a dense adjacency mask (``Relation.dense_adj``, attached by
   ``with_spmm_plans`` to small graphs), in ``dense_compute_dtype``
   (bf16 by default, as the reference's);
2. the bitmap-flash route (``ops/bitmap_gat.py``, kernels B3 to B5) when
   the graph carries a bitmap plan and no attention dropout runs;
3. fused shell-space attention (``ops/fused_gat.py``) over a shell plan
   (``with_spmm_plans(weighted=True)``);
4. the per-edge route everywhere else: ``apply_edges(u_add_v)``, leaky
   ReLU, ``edge_softmax``, the edge weights, attention dropout in training
   mode, ``update_all(u_mul_e, sum)`` (reference ``gatconv.py:337-346``).

In training, the dense and fused routes draw their attention-dropout masks
(an (H, N_dst, N_src) and an (E, H) one) with ``torch.bernoulli`` from
PyTorch's default generator of the device, where the reference draws them
from an rbg key: the two agree in distribution, not in bits.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from ... import function as fn
from ...ops.edge_softmax import edge_softmax
from .._init import flax_init
from .graphconv import check_zero_in_degree, expand_as_pair


class GATConv(nn.Module):
    """GAT layer (reference ``gatconv.py:17``).

    ``fc`` (and ``res_fc`` with ``residual``) are ``nn.Linear`` without
    bias; ``attn_l``, ``attn_r`` and ``bias`` have shape (1, H, O), as in
    the reference's flax module, so
    :func:`dgl_tpu_torch.params.from_flax_params` maps them. Parameters
    are drawn on the CPU from ``generator`` and the module is then moved to
    ``device``. Dropout runs in training mode only.
    """

    def __init__(self, in_feats: int, out_feats: int, num_heads: int,
                 feat_drop: float = 0.0, attn_drop: float = 0.0,
                 negative_slope: float = 0.2, residual: bool = False,
                 activation: Optional[Callable] = None,
                 allow_zero_in_degree: bool = False, bias: bool = True,
                 dense_compute_dtype: str = "bfloat16", *,
                 generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        H, O = num_heads, out_feats
        self.in_feats = in_feats
        self.out_feats = out_feats
        self.num_heads = num_heads
        self.attn_drop = attn_drop
        self.negative_slope = negative_slope
        self.activation = activation
        self.allow_zero_in_degree = allow_zero_in_degree
        # the dense route's (H, N_dst, N_src) attention type: bf16 halves
        # that route's traffic (the reference's default; its gradients
        # stay within 3e-2 L2-relative of the exact route's,
        # tests/test_dense_attn.py::test_dense_path_bf16_error_bound);
        # "float32" gives the per-edge route's values
        self.dense_compute_dtype = getattr(torch, dense_compute_dtype)
        self.feat_drop = nn.Dropout(feat_drop)
        self.fc = nn.Linear(in_feats, H * O, bias=False)
        with torch.no_grad():
            nn.init.xavier_uniform_(self.fc.weight, generator=generator)
        self.attn_l = nn.Parameter(
            flax_init("xavier_uniform", (1, H, O), generator))
        self.attn_r = nn.Parameter(
            flax_init("xavier_uniform", (1, H, O), generator))
        self.res_fc = None
        if residual:
            self.res_fc = nn.Linear(in_feats, H * O, bias=False)
            with torch.no_grad():
                nn.init.xavier_uniform_(self.res_fc.weight,
                                        generator=generator)
        self.bias = nn.Parameter(torch.zeros(1, H, O)) if bias else None
        self.to(device)

    def forward(self, graph, feat, edge_weight=None, get_attention=False):
        check_zero_in_degree(graph, self.allow_zero_in_degree)
        H, O = self.num_heads, self.out_feats
        with graph.local_scope() as g:
            feat_src, feat_dst = expand_as_pair(feat, g)
            # one projection serves both sides unless dropout draws a
            # separate mask for each, as the reference's does in training
            shared = feat_dst is feat_src and not (
                self.training and self.feat_drop.p > 0)
            feat_src = self.feat_drop(feat_src)
            feat_dst = feat_src if shared else self.feat_drop(feat_dst)
            h_src = self.fc(feat_src).reshape(-1, H, O)
            h_dst = (h_src if shared
                     else self.fc(feat_dst).reshape(-1, H, O))
            el = (h_src * self.attn_l).sum(-1)  # (N_src, H)
            er = (h_dst * self.attn_r).sum(-1)  # (N_dst, H)
            rel = g._relation(None)
            fused = edge_weight is None and not get_attention
            dropping = self.training and self.attn_drop > 0
            if rel.dense_adj is not None and fused:
                from ...ops.dense_attn import dense_masked_attention

                rst = dense_masked_attention(
                    rel.dense_adj, el, er, h_src,
                    negative_slope=self.negative_slope,
                    dropout_fn=self._drop if dropping else None,
                    compute_dtype=self.dense_compute_dtype)
                return self._finish(rst, feat_dst, H, O)
            if rel.bitmap_plan is not None and fused and not dropping:
                from ...ops.bitmap_gat import bitmap_gat

                rst = bitmap_gat(self.negative_slope, rel.bitmap_plan, el,
                                 er, h_src, rel)
                return self._finish(rst, feat_dst, H, O)
            if rel.shell_plan is not None and fused:
                from ...ops.fused_gat import fused_gat_attention

                drop = None
                if dropping:
                    # (E, H) eid-keyed mask, dropout after the softmax
                    drop = self._drop(h_src.new_ones((g.num_edges(), H)))
                rst = fused_gat_attention(self.negative_slope,
                                          rel.shell_plan, el, er, h_src,
                                          drop)
                return self._finish(rst, feat_dst, H, O)
            g.srcdata.update({"ft": h_src, "el": el.unsqueeze(-1)})
            g.dstdata.update({"er": er.unsqueeze(-1)})
            g.apply_edges(fn.u_add_v("el", "er", "e"))
            e = nn.functional.leaky_relu(g.edata["e"], self.negative_slope)
            a = edge_softmax(g, e)  # (E, H, 1)
            if edge_weight is not None:
                a = a * edge_weight.reshape(-1, 1, 1)
            if self.training and self.attn_drop > 0:
                a = nn.functional.dropout(a, self.attn_drop)
            g.edata["a"] = a
            g.update_all(fn.u_mul_e("ft", "a", "m"), fn.sum("m", "ft"))
            rst = self._finish(g.dstdata["ft"], feat_dst, H, O)
            return (rst, a) if get_attention else rst

    def _drop(self, a):
        """``a`` times a Bernoulli(keep) mask over ``keep``."""
        keep = 1.0 - self.attn_drop
        bits = torch.bernoulli(torch.full(a.shape, keep, device=a.device))
        return a * bits.to(a.dtype) / keep

    def _finish(self, rst, feat_dst, H, O):
        if self.res_fc is not None:
            rst = rst + self.res_fc(feat_dst).reshape(-1, H, O)
        if self.bias is not None:
            rst = rst + self.bias
        if self.activation is not None:
            rst = self.activation(rst)
        return rst
