"""Hub-cache g-SpMM: ``copy_u`` + ``sum`` with the hub rows gathered from a
compact table (counterpart of ``dgl_tpu/ops/pallas_hub.py``).

The top-H source rows by out-degree (the hubs) are packed into a table
``hub_x = x[hub_ids]``; every CSC edge carries a slot into that table, or
the sentinel ``H`` when its source is not a hub. The hub edges' messages
are the rows :func:`hub_gather` selects; the other (cold) edges gather
``x`` directly. The two message sets reduce in two sorted segment sums over
the destinations, and the results are added.

Opt-in, as in the reference: no default path calls it; ``ops.copy_u_sum``
is unchanged. :class:`HubPlan` is built once per relation on the host with
numpy and gives the reference's arrays, padding included.

:func:`hub_gather` launches the hand-written CUDA kernel
(``dgl_tpu_torch/csrc/hub_gather.cu``, kernel B6) on a CUDA table and runs
the plain PyTorch version :func:`_hub_gather_plain` on a CPU table. Both
are exact selections, so they agree to the bit.

Neither the reference nor the port has a gradient: a ``pallas_call`` has
no transpose rule, and a kernel bound with ``ctypes`` returns a tensor
without ``grad_fn``. :func:`hub_copy_u_sum` raises where one is required
instead of detaching silently.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import _kernels
from ..graph import Relation

__all__ = ["HubPlan", "hub_gather", "hub_copy_u_sum"]

CHUNK = 256     # hub-table rows per TPU one-hot matmul: H is a multiple
BLOCK_E = 2048  # edges per TPU grid step: the slots are padded to it


def _rup(x: int, m: int) -> int:
    return max(int(-(-x // m) * m), m)


@dataclass
class HubPlan:
    """Host-side edge split of one relation (reference ``pallas_hub.py:41``):
    hub slots per CSC edge plus the cold-edge tables. Build once per graph,
    reuse every step."""

    num_hubs: int                # H (multiple of CHUNK)
    hub_ids: torch.Tensor        # (H,) int64 source rows of the table
    slots: torch.Tensor          # (Ep_pad, 1) int32, H = no hub / padding
    cold_pos: torch.Tensor       # (Ec_pad,) int32 CSC positions of cold edges
    cold_src: torch.Tensor       # (Ec_pad,) int64 their source rows
    cold_dst: torch.Tensor       # (Ec_pad,) int64 their dst rows (pad num_dst)
    num_edges_padded: int        # Ep (before block padding)
    coverage: float              # fraction of real edges served by the table

    @staticmethod
    def build(rel: Relation, num_hubs: int = 2048) -> "HubPlan":
        """The reference's split (``pallas_hub.py:54-90``) with the same
        stable argsort, so every array equals the reference's."""
        src_csc, dst_csc = rel.host_arrays("csc_indices", "csc_dst")
        Ep = src_csc.shape[0]
        real = dst_csc < rel.num_dst
        deg = np.bincount(src_csc[real], minlength=rel.num_src)
        H = _rup(min(num_hubs, rel.num_src), CHUNK)
        top = np.argsort(-deg, kind="stable")[: min(num_hubs, rel.num_src)]
        hub_ids = np.zeros(H, np.int64)
        hub_ids[: top.shape[0]] = top
        slot_of = np.full(rel.num_src, H, np.int32)
        slot_of[top] = np.arange(top.shape[0], dtype=np.int32)
        # padded edges point at the sink row num_src: no slot for them
        slots = np.full(Ep, H, np.int32)
        slots[real] = slot_of[src_csc[real]]
        cold = real & (slots == H)
        cold_idx = np.nonzero(cold)[0]
        Ec = _rup(cold_idx.shape[0], 8) if cold_idx.size else 8
        cold_pos = np.full(Ec, Ep, np.int32)
        cold_src = np.zeros(Ec, np.int64)
        cold_dst = np.full(Ec, rel.num_dst, np.int64)
        cold_pos[: cold_idx.shape[0]] = cold_idx
        cold_src[: cold_idx.shape[0]] = src_csc[cold_idx]
        cold_dst[: cold_idx.shape[0]] = dst_csc[cold_idx]
        slots_pad = np.full((_rup(Ep, BLOCK_E), 1), H, np.int32)
        slots_pad[:Ep, 0] = slots
        n_real = max(int(real.sum()), 1)
        dev = rel.device
        return HubPlan(
            num_hubs=H,
            hub_ids=torch.from_numpy(hub_ids).to(dev),
            slots=torch.from_numpy(slots_pad).to(dev),
            cold_pos=torch.from_numpy(cold_pos).to(dev),
            cold_src=torch.from_numpy(cold_src).to(dev),
            cold_dst=torch.from_numpy(cold_dst).to(dev),
            num_edges_padded=Ep,
            coverage=float((real & (slots < H)).sum() / n_real),
        )


def _check_shapes(hub_x, slots, precision):
    if precision not in ("highest", "bf16"):
        raise ValueError(f"hub_gather: unknown precision {precision!r}")
    H = hub_x.shape[0]
    E = slots.shape[0]
    if H % CHUNK or E % BLOCK_E:
        raise ValueError("hub_gather: H % 256 == 0 and E % 2048 == 0 required")


def _hub_gather_plain(hub_x, slots, precision: str = "highest"):
    """Plain PyTorch version of :func:`hub_gather`: an ``index_select`` from
    the table with a zero row appended, which every slot outside
    ``[0, H)`` selects."""
    H, F = hub_x.shape
    table = hub_x
    if precision == "bf16":
        table = hub_x.to(torch.bfloat16).to(hub_x.dtype)
    table = torch.cat([table, table.new_zeros((1, F))])
    s = slots.reshape(-1).to(torch.int64)
    s = torch.where((s < 0) | (s >= H), H, s)
    return table.index_select(0, s)


def hub_gather(hub_x, slots, precision: str = "highest"):
    """``out[i] = hub_x[slots[i]]``, or 0 where ``slots[i]`` is the sentinel
    ``H`` (reference ``pallas_hub.py:112``).

    ``hub_x``: (H, F) f32 or bf16 with H % 256 == 0. ``slots``: (E, 1) or
    (E,) int32 with E % 2048 == 0: the reference's contract, checked on
    both devices. ``precision``: ``"highest"`` selects the values as they
    are; ``"bf16"`` rounds them to bf16 (what the reference's one-hot bf16
    product gives for a single nonzero). Returns (E, F) in ``hub_x``'s
    dtype.

    A CUDA table launches kernel B6; a CPU table runs the plain version.
    """
    _check_shapes(hub_x, slots, precision)
    if hub_x.device.type == "cpu":
        return _hub_gather_plain(hub_x, slots, precision)
    if not hub_x.is_cuda:
        raise ValueError(f"hub_gather: unsupported device {hub_x.device}")
    return _launch(hub_x, slots, precision)


def _launch(hub_x, slots, precision):
    dev = hub_x.device
    if hub_x.dtype not in (torch.float32, torch.bfloat16) or hub_x.dim() != 2:
        raise ValueError(f"hub_x must be 2-D f32 or bf16, got {hub_x.dtype} "
                         f"{tuple(hub_x.shape)}")
    if slots.dtype != torch.int32 or slots.device != dev or not (
            slots.dim() == 1 or (slots.dim() == 2 and slots.shape[1] == 1)):
        raise ValueError("slots must be (E, 1) or (E,) int32 on hub_x's "
                         "device")
    H, F = hub_x.shape
    E = slots.shape[0]
    hub_x = hub_x.contiguous()
    slots = slots.contiguous()
    out = torch.empty((E, F), dtype=hub_x.dtype, device=dev)
    # 16 bytes a thread where the rows allow it: 4 f32 or 8 bf16
    vec = 16 // hub_x.element_size()
    if F % vec or hub_x.data_ptr() % 16 or out.data_ptr() % 16:
        vec = 1
    lib = _kernels.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.dgl_hub_gather(
            hub_x.data_ptr(), H, F, int(hub_x.dtype == torch.bfloat16),
            slots.data_ptr(), E, int(precision == "bf16"), out.data_ptr(),
            vec, stream)
    _kernels.check(code, "hub_gather")
    _kernels.launch_counts["hub_gather"] += 1
    return out


def hub_copy_u_sum(rel: Relation, x, plan: HubPlan = None,
                   num_hubs: int = 2048, precision: str = "highest"):
    """``copy_u`` + ``sum`` through the hub table (reference
    ``pallas_hub.py:143``). Matches ``ops.copy_u_sum(g, x)`` at the default
    precision; pass a prebuilt ``plan`` to build the split once.

    ``x``: (num_src, F). Returns (num_dst, F) in ``x``'s dtype. Raises when
    grad mode is on and ``x`` requires a gradient: neither the reference
    nor the port differentiates this path."""
    if torch.is_grad_enabled() and x.requires_grad:
        raise RuntimeError(
            "hub_copy_u_sum has no gradient (the reference's pallas_call has "
            "no transpose rule either): use ops.copy_u_sum to train, or call "
            "it under torch.no_grad()")
    if plan is None:
        plan = HubPlan.build(rel, num_hubs)
    F = x.shape[1]
    n = rel.num_dst
    # the reference pads F to the TPU's 128 lanes and slices it off again:
    # the kernel takes any F, so the output is the same without it
    hub_x = x.index_select(0, plan.hub_ids)
    msgs = hub_gather(hub_x, plan.slots, precision=precision)
    # padded CSC edges carry dst == num_dst and cold padding rows too: sum
    # into one extra row and drop it (index_add_ has no out-of-range drop)
    out_hub = x.new_zeros((n + 1, F)).index_add_(
        0, rel.csc_dst, msgs[: plan.num_edges_padded])
    cold = x.index_select(0, plan.cold_src)
    out_cold = x.new_zeros((n + 1, F)).index_add_(0, plan.cold_dst, cold)
    return out_hub[:n] + out_cold[:n]
