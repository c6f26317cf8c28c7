"""Device health checks (counterpart of ``dgl_tpu/health.py``).

``check_devices`` probes the card in a subprocess with a hard timeout (a
wedged device runtime can hang the probing process itself, so the probe
runs out of process). ``run_with_watchdog`` guards a computation with SIGALRM; its
``fallback`` is the caller's own.
"""
from __future__ import annotations

import signal
import subprocess
import sys
from typing import Callable, Optional

__all__ = ["check_devices", "run_with_watchdog", "DeviceTimeout"]

_PROBE = "import torch; print(float(torch.ones(8, 8, device={!r}).sum()))"


class DeviceTimeout(Exception):
    pass


def check_devices(timeout_s: int = 120, device="cuda") -> bool:
    """True iff a fresh process can sum ``torch.ones(8, 8)`` on ``device``
    (the CUDA card by default) to 64 within ``timeout_s`` seconds."""
    try:
        r = subprocess.run([sys.executable, "-c", _PROBE.format(str(device))],
                           timeout=timeout_s, capture_output=True)
        return r.returncode == 0 and b"64.0" in r.stdout
    except subprocess.TimeoutExpired:
        return False


def run_with_watchdog(fn: Callable, timeout_s: int,
                      fallback: Optional[Callable] = None):
    """Run ``fn()`` with a SIGALRM watchdog; on expiry call ``fallback()``
    (or raise DeviceTimeout). Main-thread only."""

    def _handler(signum, frame):
        raise DeviceTimeout()

    prev = signal.signal(signal.SIGALRM, _handler)
    signal.alarm(timeout_s)
    try:
        return fn()
    except DeviceTimeout:
        if fallback is not None:
            return fallback()
        raise
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, prev)
