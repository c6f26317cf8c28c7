"""TWIRLS conv (counterpart of ``dgl_tpu/nn/conv/twirlsconv.py``;
reference ``python/dgl/nn/pytorch/conv/twirlsconv.py``): MLP, unrolled
graph-smoothing propagation (optionally reweighted by attention), MLP,
from "Graph Neural Networks Inspired by Classical Iterative Algorithms"
(arXiv:2103.06064). Each propagation step is a ``copy_u`` sum (through a
hub plan's kernel where the graph has one), or after the attention a
``u_mul_e`` sum with the edge weights."""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ... import function as fn
from .._init import dense

__all__ = ["TWIRLSConv", "TWIRLSUnfoldingAndAttention", "AX", "D_power_X",
           "D_power_bias_X", "normalized_AX", "Propagate",
           "PropagateNoPrecond", "Attention", "MLP"]


def _edge_dist(g, y):
    """``||y_u - y_v||`` per edge (E,): a ``u_sub_v`` g-SDDMM and a norm
    (whose gradient is 0 where the distance is 0)."""
    with g.local_scope() as gg:
        gg.srcdata["y"] = y
        gg.dstdata["y"] = y[:gg.num_dst_nodes()]
        gg.apply_edges(fn.u_sub_v("y", "y", "d"))
        return torch.linalg.vector_norm(gg.edata["d"], dim=-1)


class TWIRLSUnfoldingAndAttention(nn.Module):
    """Propagation block (reference ``TWIRLSUnfoldingAndAttention``):
    ``prop_step`` gradient steps on the TWIRLS energy,
    ``y <- (1 - alp (1 + lam)) y + alp y0 + alp lam D^-1/2 A D^-1/2 y``
    (degrees plus ``lam``, at least 1), ``alp`` ``1 / (1 + lam)`` unless
    given; with ``attention``, after step ``attn_aft`` the edges are
    reweighted by ``(||y_u - y_v|| + tau)^(p - 2)``. No parameters."""

    def __init__(self, prop_step: int, lam: float = 1.0, alp: float = 0.0,
                 attention: bool = False, attn_aft: int = -1,
                 p: float = 1.0, tau: float = 0.2):
        super().__init__()
        self.prop_step, self.lam, self.alp = prop_step, lam, alp
        self.attention, self.attn_aft = attention, attn_aft
        self.p, self.tau = p, tau

    def forward(self, g, x):
        lam = self.lam
        alp = self.alp if self.alp > 0 else 1.0 / (1.0 + lam)
        ni = torch.rsqrt(g.in_degrees().to(x.dtype).clamp_min(1) + lam
                         ).unsqueeze(-1)
        no = torch.rsqrt(g.out_degrees().to(x.dtype).clamp_min(1) + lam
                         ).unsqueeze(-1)
        attn_aft = self.attn_aft if self.attention else -1
        y0 = y = x
        ew = None
        for step in range(self.prop_step):
            with g.local_scope() as gg:
                gg.srcdata["h"] = y * no
                if ew is not None:
                    gg.edata["w"] = ew
                    gg.update_all(fn.u_mul_e("h", "w", "m"), fn.sum("m", "h"))
                else:
                    gg.update_all(fn.copy_u("h", "m"), fn.sum("m", "h"))
                agg = gg.dstdata["h"] * ni
            y = (1 - alp * (1 + lam)) * y + alp * y0 + alp * lam * agg
            if step == attn_aft:
                ew = torch.pow(_edge_dist(g, y).unsqueeze(-1) + self.tau,
                               self.p - 2.0)
        return y


class TWIRLSConv(nn.Module):
    """(reference ``twirlsconv.py:11``). ``mlp_bef<i>`` (``num_mlp_before``
    layers to ``hidden_d``, ReLU, dropout) and ``mlp_aft<i>``
    (``num_mlp_after`` layers, the last to ``output_d``, ReLU between):
    ``nn.Linear`` drawn as flax's ``Dense`` default. The propagation runs
    ``prop_step`` steps, the attention after ``prop_step // 2``. ``norm``
    and ``precond`` are kept for the reference's signature and unused, as
    there."""

    def __init__(self, input_d: int, output_d: int, hidden_d: int,
                 prop_step: int, num_mlp_before: int = 1,
                 num_mlp_after: int = 1, norm: str = "none",
                 precond: bool = True, alp: float = 0.0, lam: float = 1.0,
                 attention: bool = False, tau: float = 0.2, p: float = 1.0,
                 dropout: float = 0.0, *,
                 generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        self.num_mlp_before, self.num_mlp_after = (num_mlp_before,
                                                   num_mlp_after)
        width = input_d
        for i in range(num_mlp_before):
            self.add_module(f"mlp_bef{i}", dense(width, hidden_d,
                                                 generator=generator))
            width = hidden_d
        self.prop = TWIRLSUnfoldingAndAttention(
            prop_step, lam, alp, attention,
            prop_step // 2 if attention else -1, p, tau)
        for i in range(num_mlp_after):
            out_d = output_d if i == num_mlp_after - 1 else hidden_d
            self.add_module(f"mlp_aft{i}", dense(width, out_d,
                                                 generator=generator))
            width = out_d
        self.dropout = nn.Dropout(dropout)
        self.to(device)

    def forward(self, graph, feat):
        h = feat
        for i in range(self.num_mlp_before):
            h = self.dropout(torch.relu(getattr(self, f"mlp_bef{i}")(h)))
        h = self.prop(graph, h)
        for i in range(self.num_mlp_after):
            h = getattr(self, f"mlp_aft{i}")(h)
            if i != self.num_mlp_after - 1:
                h = torch.relu(h)
        return h


# -- the functional TWIRLS pieces (reference ``twirlsconv.py:228-700``) ----


def AX(graph, X):
    """``Y = A X``, weighted by ``edata['w']`` when the graph has it
    (reference ``twirlsconv.py:442``)."""
    with graph.local_scope() as g:
        g.srcdata["h"] = X
        if "w" in g.edata:
            g.update_all(fn.u_mul_e("h", "w", "m"), fn.sum("m", "h"))
        else:
            g.update_all(fn.copy_u("h", "m"), fn.sum("m", "h"))
        return g.dstdata["h"]


def _degrees(graph, X):
    """``ndata['deg']`` where the graph has it (the reference's contract),
    else the in-degrees."""
    degs = graph.ndata.get("deg")
    if degs is None:
        degs = graph.in_degrees()
    return torch.as_tensor(degs, device=X.device).to(X.dtype)


def D_power_X(graph, X, power):
    """``Y = D^power X`` (reference ``twirlsconv.py:455``)."""
    return X * torch.pow(_degrees(graph, X), power).unsqueeze(-1)


def D_power_bias_X(graph, X, power, coeff, bias):
    """``Y = (coeff D + bias I)^power X`` (reference
    ``twirlsconv.py:464``)."""
    return X * torch.pow(coeff * _degrees(graph, X) + bias,
                         power).unsqueeze(-1)


def normalized_AX(graph, X):
    """``Y = D^-1/2 A D^-1/2 X`` (reference ``twirlsconv.py:432``)."""
    return D_power_X(graph, AX(graph, D_power_X(graph, X, -0.5)), -0.5)


class Propagate(nn.Module):
    """Pre-conditioned propagation step (reference ``twirlsconv.py:228``,
    eq. 28): ``Y <- (1 - alp) Y + alp X + alp lam A~ Y``,
    ``A~ = (lam D + (1 - lam) I)^-1/2 A (lam D + (1 - lam) I)^-1/2``."""

    def _prop(self, graph, Y, lam):
        Y = D_power_bias_X(graph, Y, -0.5, lam, 1 - lam)
        Y = AX(graph, Y)
        return D_power_bias_X(graph, Y, -0.5, lam, 1 - lam)

    def forward(self, graph, Y, X, alp, lam):
        return (1 - alp) * Y + alp * X + alp * lam * self._prop(graph, Y,
                                                                 lam)


class PropagateNoPrecond(nn.Module):
    """Unconditioned variant (reference ``twirlsconv.py:283``, eq. 30)."""

    def forward(self, graph, Y, X, alp, lam):
        return ((1 - alp * (1 + lam)) * Y + alp * X
                + alp * lam * normalized_AX(graph, Y))


class Attention(nn.Module):
    """TWIRLS attention reweighting (reference ``twirlsconv.py:326``,
    eq. 27): ``w_uv = max(||y_u - y_v||, tau)^(p - 2)``, at most
    ``T^(p - 2)`` when ``T > 0``, stored in ``edata['w']``."""

    def __init__(self, tau: float, T: float, p: float,
                 attn_dropout: float = 0.0):
        super().__init__()
        self.tau, self.T, self.p = tau, T, p

    def reweighting(self, graph, Y):
        dist = _edge_dist(graph, Y)
        w = torch.pow(torch.maximum(dist, torch.full_like(dist, self.tau)),
                      self.p - 2.0)
        if self.T > 0:
            w = torch.minimum(w, torch.full_like(w, self.T ** (self.p - 2.0)))
        return w

    def forward(self, graph, Y):
        graph.edata["w"] = self.reweighting(graph, Y)
        return graph


class MLP(nn.Module):
    """Plain MLP around the TWIRLS unfolding (reference
    ``twirlsconv.py:607``): ``layers.<i>`` (flax: ``Dense_<i>``), ReLU and
    dropout between."""

    def __init__(self, in_size: int, hidden_sizes: Sequence[int],
                 dropout: float = 0.0, *,
                 generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        sizes = (in_size,) + tuple(hidden_sizes)
        self.layers = nn.ModuleList(
            dense(a, b, generator=generator)
            for a, b in zip(sizes[:-1], sizes[1:]))
        self.dropout = nn.Dropout(dropout)
        self.to(device)

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = self.dropout(torch.relu(x))
        return x
