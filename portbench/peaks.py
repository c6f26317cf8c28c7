"""The card's published peaks (NVIDIA's data sheet, dense, at the full power
limit), by the name that ``torch.cuda.get_device_name()`` gives. Only the
card the benchmark has been measured on is listed; any other raises."""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Peaks:
    hbm_bytes_per_s: float
    f32_flops_per_s: float  # float32 outside the tensor cores


CARDS = {"NVIDIA H100 80GB HBM3": Peaks(3.35e12, 67e12)}  # H100 SXM


def of(card_name: str) -> Peaks:
    if card_name not in CARDS:
        raise RuntimeError(f"no peaks on record for {card_name!r}")
    return CARDS[card_name]
