"""Sampling (counterpart of ``dgl_tpu/sampling/``). Ported: the on-device
neighbour sampler; the host samplers (neighbor, labor, random walks,
negative, PinSAGE) are ROADMAP queue A9."""
from .device_sampler import (DeviceMFG, DeviceNeighborSampler,
                             device_seed_batches)

__all__ = ["DeviceMFG", "DeviceNeighborSampler", "device_seed_batches"]
