"""Global pooling and readout layers (counterpart of ``dgl_tpu/nn/glob.py``;
reference ``python/dgl/nn/pytorch/glob.py:31-1305``), over the readouts of
``readout.py``, and the set-transformer blocks over each graph's nodes as a
dense padded batch.

Parameter names follow the reference's flax modules, so
``from_flax_params`` carries its parameters over: ``Set2Set``'s
``lstm`` is a ``torch.nn.LSTMCell`` whose ``bias_ih`` stays 0 (flax's
``OptimizedLSTMCell`` has no input bias; a gradient hook zeroes it), and
the layer norms take flax's epsilon, 1e-6.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .. import readout
from ._init import dense, flax_init

__all__ = [
    "SumPooling",
    "AvgPooling",
    "MaxPooling",
    "SortPooling",
    "GlobalAttentionPooling",
    "Set2Set",
    "WeightAndSum",
    "MultiHeadAttention",
    "SetAttentionBlock",
    "InducedSetAttentionBlock",
    "PMALayer",
    "SetTransformerEncoder",
    "SetTransformerDecoder",
]


def _pool(op, graph, feat):
    with graph.local_scope() as g:
        g.ndata["_pool"] = feat
        return op(g, "_pool")


class SumPooling(nn.Module):
    """Each graph's node features summed (reference ``glob.py:31``)."""

    def forward(self, graph, feat):
        return _pool(readout.sum_nodes, graph, feat)


class AvgPooling(nn.Module):
    """Each graph's node features averaged (reference ``glob.py:81``)."""

    def forward(self, graph, feat):
        return _pool(readout.mean_nodes, graph, feat)


class MaxPooling(nn.Module):
    """Each graph's node features' maximum (reference ``glob.py:131``)."""

    def forward(self, graph, feat):
        return _pool(readout.max_nodes, graph, feat)


class SortPooling(nn.Module):
    """Each node's channels sorted, then each graph's ``k`` nodes of the
    largest last channel, flattened to (B, k * F) (reference
    ``glob.py:182``; ties and short graphs as ``readout.topk_nodes``)."""

    def __init__(self, k: int):
        super().__init__()
        self.k = k

    def forward(self, graph, feat):
        with graph.local_scope() as g:
            g.ndata["_pool"] = torch.sort(feat, dim=-1).values
            vals, _ = readout.topk_nodes(g, "_pool", self.k, sortby=-1)
            return vals.reshape(graph.batch_size, -1)


class GlobalAttentionPooling(nn.Module):
    """``sum_v softmax_v(gate_nn(x_v)) * feat_nn(x_v)`` over each graph's
    nodes (reference ``glob.py:238``); ``feat_nn`` defaults to the
    identity. ``forward(graph, feat, get_attention=False)`` returns the
    (B, F) readout, and with ``get_attention`` the (N, 1) gates."""

    def __init__(self, gate_nn: nn.Module, feat_nn: Optional[nn.Module] = None):
        super().__init__()
        self.gate_nn = gate_nn
        self.feat_nn = feat_nn

    def forward(self, graph, feat, get_attention=False):
        with graph.local_scope() as g:
            gate = self.gate_nn(feat)
            feat = self.feat_nn(feat) if self.feat_nn is not None else feat
            g.ndata["_gate"] = gate
            gate = readout.softmax_nodes(g, "_gate")
            g.ndata.pop("_gate")
            g.ndata["_r"] = feat * gate
            out = readout.sum_nodes(g, "_r")
            return (out, gate) if get_attention else out


class Set2Set(nn.Module):
    """Set2Set (reference ``glob.py:316``): ``n_iters`` steps of an LSTM
    cell over ``q* = [q, r]`` (zeros first), ``r`` the attention readout of
    the nodes against ``q``; output (B, 2 * input_dim). ``n_layers`` is
    kept for the reference's signature, which runs one cell."""

    def __init__(self, input_dim: int, n_iters: int, n_layers: int = 1, *,
                 generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        self.input_dim, self.n_iters, self.n_layers = (input_dim, n_iters,
                                                       n_layers)
        self.lstm = nn.LSTMCell(2 * input_dim, input_dim)
        with torch.no_grad():
            for w in self.lstm.weight_ih.split(input_dim):
                w.copy_(flax_init("lecun_normal", (2 * input_dim, input_dim),
                                  generator).T)
            for w in self.lstm.weight_hh.split(input_dim):
                nn.init.orthogonal_(w, generator=generator)
            self.lstm.bias_ih.zero_()
            self.lstm.bias_hh.zero_()
        self.to(device)
        self.lstm.bias_ih.register_hook(torch.zeros_like)

    def forward(self, graph, feat):
        with graph.local_scope() as g:
            B = graph.batch_size
            h = feat.new_zeros((B, self.input_dim))
            c = feat.new_zeros((B, self.input_dim))
            q_star = feat.new_zeros((B, 2 * self.input_dim))
            for _ in range(self.n_iters):
                h, c = self.lstm(q_star, (h, c))
                q = h
                g.ndata["_e"] = (feat * readout.broadcast_nodes(g, q)).sum(
                    -1, keepdim=True)
                alpha = readout.softmax_nodes(g, "_e")
                g.ndata["_r"] = feat * alpha
                r = readout.sum_nodes(g, "_r")
                q_star = torch.cat([q, r], dim=-1)
            return q_star


class WeightAndSum(nn.Module):
    """Each graph's node features summed, weighted by
    ``sigmoid(atom_weighting(x))`` (reference ``glob.py:1305``)."""

    def __init__(self, in_feats: int, *,
                 generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        self.atom_weighting = dense(in_feats, 1, generator=generator)
        self.to(device)

    def forward(self, graph, feat):
        w = torch.sigmoid(self.atom_weighting(feat))
        with graph.local_scope() as g:
            g.ndata["_wx"] = feat * w
            return readout.readout_nodes(g, "_wx", op="sum")


class MultiHeadAttention(nn.Module):
    """The set transformer's attention block (reference ``glob.py:660``):
    ``norm_in(x + proj_o(MHA(x, mem)))``, then ``norm_inter(x +
    ffn1(relu(ffn0(x))))``. ``forward(x, mem, lengths_x=None,
    lengths_mem=None)`` over (B, Nx, D) and (B, Nm, D); like the
    reference it masks nothing, so the lengths and dropouts are kept for
    its signature only."""

    def __init__(self, d_model: int, num_heads: int, d_head: int, d_ff: int,
                 dropouth: float = 0.0, dropouta: float = 0.0, *,
                 generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        self.num_heads, self.d_head = num_heads, d_head
        for name in ("proj_q", "proj_k", "proj_v"):
            self.add_module(name, dense(d_model, num_heads * d_head, False,
                                        generator=generator))
        self.proj_o = dense(num_heads * d_head, d_model, generator=generator)
        self.norm_in = nn.LayerNorm(d_model, eps=1e-6)
        self.ffn0 = dense(d_model, d_ff, generator=generator)
        self.ffn1 = dense(d_ff, d_model, generator=generator)
        self.norm_inter = nn.LayerNorm(d_model, eps=1e-6)
        self.to(device)

    def forward(self, x, mem, lengths_x=None, lengths_mem=None):
        H, Dh = self.num_heads, self.d_head
        B, Nx, Nm = x.shape[0], x.shape[1], mem.shape[1]
        q = self.proj_q(x).reshape(B, Nx, H, Dh)
        k = self.proj_k(mem).reshape(B, Nm, H, Dh)
        v = self.proj_v(mem).reshape(B, Nm, H, Dh)
        score = torch.einsum("bxhd,bmhd->bxmh", q, k) / Dh ** 0.5
        att = torch.softmax(score, dim=2)
        out = torch.einsum("bxmh,bmhd->bxhd", att, v).reshape(B, Nx, H * Dh)
        x = self.norm_in(x + self.proj_o(out))
        return self.norm_inter(x + self.ffn1(torch.relu(self.ffn0(x))))


class SetAttentionBlock(nn.Module):
    """SAB (reference ``glob.py:779``): ``mha(x, x)``."""

    def __init__(self, d_model: int, num_heads: int, d_head: int, d_ff: int,
                 *, generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        self.mha = MultiHeadAttention(d_model, num_heads, d_head, d_ff,
                                      generator=generator, device=device)

    def forward(self, x):
        return self.mha(x, x)


class InducedSetAttentionBlock(nn.Module):
    """ISAB (reference ``glob.py:830``): ``mha1(x, mha0(I, x))`` through
    ``m`` learned inducing points ``I`` (1, m, d_model)."""

    def __init__(self, m: int, d_model: int, num_heads: int, d_head: int,
                 d_ff: int, *, generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        self.inducing_points = nn.Parameter(flax_init(
            "xavier_uniform", (1, m, d_model), generator))
        self.mha0 = MultiHeadAttention(d_model, num_heads, d_head, d_ff,
                                       generator=generator, device=device)
        self.mha1 = MultiHeadAttention(d_model, num_heads, d_head, d_ff,
                                       generator=generator, device=device)
        self.to(device)

    def forward(self, x):
        ind = self.inducing_points.expand(x.shape[0], -1, -1)
        return self.mha1(x, self.mha0(ind, x))


class PMALayer(nn.Module):
    """Pooling by multi-head attention (reference ``glob.py:918``):
    ``mha(S, relu(rff(x)))`` with ``k`` learned seed vectors ``S``
    (1, k, d_model)."""

    def __init__(self, k: int, d_model: int, num_heads: int, d_head: int,
                 d_ff: int, *, generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        self.seed_vectors = nn.Parameter(flax_init(
            "xavier_uniform", (1, k, d_model), generator))
        self.rff = dense(d_model, d_model, generator=generator)
        self.mha = MultiHeadAttention(d_model, num_heads, d_head, d_ff,
                                      generator=generator, device=device)
        self.to(device)

    def forward(self, x):
        seed = self.seed_vectors.expand(x.shape[0], -1, -1)
        return self.mha(seed, torch.relu(self.rff(x)))


class SetTransformerEncoder(nn.Module):
    """``n_layers`` SAB (``sab<i>``) or ISAB (``isab<i>``, ``m`` inducing
    points, default 16) blocks over each graph's nodes as a padded batch;
    node features out (reference ``glob.py:1006``)."""

    def __init__(self, d_model: int, n_heads: int, d_head: int, d_ff: int,
                 n_layers: int = 1, block_type: str = "sab",
                 m: Optional[int] = None, *,
                 generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        self.names = []
        for i in range(n_layers):
            if block_type == "isab":
                block = InducedSetAttentionBlock(
                    m or 16, d_model, n_heads, d_head, d_ff,
                    generator=generator, device=device)
                name = f"isab{i}"
            else:
                block = SetAttentionBlock(d_model, n_heads, d_head, d_ff,
                                          generator=generator, device=device)
                name = f"sab{i}"
            self.add_module(name, block)
            self.names.append(name)

    def forward(self, graph, feat):
        x, _ = _to_dense_batch(graph, feat)
        for name in self.names:
            x = getattr(self, name)(x)
        return _from_dense_batch(graph, x, feat.shape[0])


class SetTransformerDecoder(nn.Module):
    """``pma`` pooling to ``k`` vectors, then ``n_layers`` SAB blocks,
    flattened to (B, k * d_model) (reference ``glob.py:1168``)."""

    def __init__(self, d_model: int, num_heads: int, d_head: int, d_ff: int,
                 n_layers: int, k: int, *,
                 generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        self.k, self.d_model, self.n_layers = k, d_model, n_layers
        self.pma = PMALayer(k, d_model, num_heads, d_head, d_ff,
                            generator=generator, device=device)
        for i in range(n_layers):
            self.add_module(f"sab{i}", SetAttentionBlock(
                d_model, num_heads, d_head, d_ff, generator=generator,
                device=device))

    def forward(self, graph, feat):
        x, _ = _to_dense_batch(graph, feat)
        x = self.pma(x)
        for i in range(self.n_layers):
            x = getattr(self, f"sab{i}")(x)
        return x.reshape(x.shape[0], self.k * self.d_model)


def _dense_slots(graph, device):
    """Each node's (graph, position) slot in the (B, n_max) padded batch,
    and n_max (one host read of the batch sizes)."""
    bnn = graph.batch_num_nodes().to(device)
    total = int(bnn.sum())
    ids = torch.repeat_interleave(torch.arange(bnn.shape[0], device=device),
                                  bnn, output_size=total)
    starts = torch.cumsum(bnn, 0) - bnn
    pos = torch.arange(total, device=device) - starts[ids]
    n_max = int(bnn.max()) if bnn.numel() else 0
    return ids, pos, n_max


def _to_dense_batch(graph, feat):
    """Each graph's node features as a (B, n_max, F) batch, zeros past a
    graph's nodes, and the (B, n_max) mask of real slots."""
    ids, pos, n_max = _dense_slots(graph, feat.device)
    B = graph.batch_size
    x = feat.new_zeros((B, n_max) + tuple(feat.shape[1:]))
    x = x.index_put((ids, pos), feat[: ids.shape[0]])
    mask = torch.zeros((B, n_max), dtype=torch.bool, device=feat.device)
    mask[ids, pos] = True
    return x, mask


def _from_dense_batch(graph, x, total_nodes):
    """The real slots of a (B, n_max, ...) batch back as (total_nodes, ...)
    node rows, zeros past the batch's nodes."""
    ids, pos, _ = _dense_slots(graph, x.device)
    out = x.new_zeros((total_nodes,) + tuple(x.shape[2:]))
    return out.index_put((torch.arange(ids.shape[0], device=x.device),),
                         x[ids, pos])
