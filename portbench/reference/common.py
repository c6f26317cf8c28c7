"""What the reference families share: the sum aggregation over an edge
list with the configuration's rounding of the gathered rows, the linears,
the loss and Adam, each written out in plain PyTorch.

``Precision`` is the stated precision of a configuration, or a control one
step below it:

- ``rows``: the dtype the gathered rows are rounded to before the f32 sum
  (the hub plan's bf16 rows; ``float8_e4m3fn``, scaled, in the control),
  in both directions: the forward gathers rounded source rows, the
  backward rounded output gradients;
- ``linears``: ``"f32"`` (TF32 off), or ``"tf32"`` in the control: the
  operands rounded to TF32's 10-bit mantissa (round to nearest), then
  multiplied and summed in f32, as a TF32 tensor-core product does.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

DTYPES = {"bfloat16": torch.bfloat16, "float8_e4m3fn": torch.float8_e4m3fn,
          "float32": torch.float32}


@dataclass(frozen=True)
class Precision:
    rows: torch.dtype = torch.bfloat16
    linears: str = "f32"

    @classmethod
    def stated(cls, cfg: dict) -> "Precision":
        p = cfg["precision"]
        if p["tf32"]:
            raise ValueError("the references state linears with TF32 off")
        return cls(DTYPES[p["gathered_rows"]], "f32")


# the controls: each stated precision one step lower, alone and together
CONTROLS = {"control": Precision(torch.float8_e4m3fn, "tf32"),
            "tf32": Precision(torch.bfloat16, "tf32"),
            "fp8_rows": Precision(torch.float8_e4m3fn, "f32")}


def round_rows(t, dtype):
    """``t`` (f32) rounded to ``dtype`` and back. float8 is scaled by the
    tensor's largest magnitude first, as an fp8 path scales it (unscaled,
    the gradients would fall under its smallest value)."""
    if dtype == torch.float32:
        return t
    if dtype != torch.float8_e4m3fn:
        return t.to(dtype).to(torch.float32)
    scale = t.abs().amax().clamp(min=1e-30) / torch.finfo(dtype).max
    return (t / scale).to(dtype).to(torch.float32) * scale


def round_tf32(t):
    """``t`` (f32) rounded to TF32's 10 mantissa bits, to nearest."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


class _TF32MatMul(torch.autograd.Function):
    """``a @ b`` with every product's operands rounded to TF32, the
    backward's two products as well, as TF32 GEMMs compute all three."""

    @staticmethod
    def forward(ctx, a, b):
        a, b = round_tf32(a), round_tf32(b)
        ctx.save_for_backward(a, b)
        return a @ b

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = round_tf32(g)
        return g @ b.t(), a.t() @ g


def matmul(a, b, prec: Precision):
    if prec.linears == "tf32":
        return _TF32MatMul.apply(a, b)
    return a @ b


class _RoundedSum(torch.autograd.Function):
    """``out[d] = sum over edges (s, d) of round(t[s])`` in f32; its
    gradient ``dt[s] = sum over edges of round(dout[d])``."""

    @staticmethod
    def forward(ctx, t, src, dst, n_out, dtype):
        ctx.save_for_backward(src, dst)
        ctx.n_in, ctx.dtype = t.shape[0], dtype
        rows = round_rows(t, dtype).index_select(0, src)
        return t.new_zeros((n_out, t.shape[1])).index_add_(0, dst, rows)

    @staticmethod
    def backward(ctx, dout):
        src, dst = ctx.saved_tensors
        rows = round_rows(dout, ctx.dtype).index_select(0, dst)
        dt = dout.new_zeros((ctx.n_in, dout.shape[1])).index_add_(0, src,
                                                                  rows)
        return dt, None, None, None, None


def rounded_sum(t, src, dst, n_out: int, prec: Precision):
    return _RoundedSum.apply(t, src, dst, n_out, prec.rows)


def degrees(idx, n: int):
    return torch.bincount(idx, minlength=n).to(torch.float32)


def masked_loss(logits, y, mask):
    """Softmax cross-entropy averaged over the nodes of ``mask`` (float)."""
    ce = F.cross_entropy(logits, y, reduction="none")
    return (ce * mask).sum() / mask.sum()


class Adam:
    """Adam as ``torch.optim.Adam`` defines it (no weight decay, no
    amsgrad), written out; ``step`` takes the gradients, None for a leaf
    that got none (left as it is)."""

    def __init__(self, params: dict, lr: float, betas=(0.9, 0.999),
                 eps: float = 1e-8):
        self.params, self.lr, self.eps = params, lr, eps
        self.b1, self.b2 = betas
        self.t = 0
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def step(self, grads: dict) -> None:
        self.t += 1
        bc1 = 1 - self.b1 ** self.t
        bc2 = 1 - self.b2 ** self.t
        for k, p in self.params.items():
            g = grads.get(k)
            if g is None:
                continue
            self.m[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            denom = (self.v[k].sqrt() / bc2 ** 0.5).add_(self.eps)
            p.addcdiv_(self.m[k], denom, value=-self.lr / bc1)


def xavier_bound(fan_in: int, fan_out: int) -> float:
    return (6.0 / (fan_in + fan_out)) ** 0.5


BIAS_BOUND = 0.1  # biases drawn too, so that their path is compared
