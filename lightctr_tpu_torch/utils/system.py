"""System observability helpers.

Parity with ``common/system.h``: ``SystemMemoryUsage`` reads /proc/meminfo
(system.h:63-98); the device-side counterpart reads the card's memory
stats, which the reference (CPU-only) never had.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch


def host_memory_usage() -> Dict[str, int]:
    """kB values from /proc/meminfo (MemTotal/MemFree/MemAvailable)."""
    out: Dict[str, int] = {}
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                key, rest = line.split(":", 1)
                if key in ("MemTotal", "MemFree", "MemAvailable", "Cached"):
                    out[key] = int(rest.split()[0])
    except OSError:
        pass
    return out


def device_memory_stats(device=None) -> Optional[Dict[str, int]]:
    """The caching allocator's ``torch.cuda.memory_stats`` for a CUDA
    device (the current one when ``device`` is None and CUDA is present);
    None for the CPU, which keeps no such stats."""
    if device is None:
        if not torch.cuda.is_available():
            return None
        device = torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    return dict(torch.cuda.memory_stats(dev))
