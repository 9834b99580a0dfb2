"""Device resolution for the port's entry points.

Every entry point (``ServingModel``, ``HotEmbeddingCache``,
``PredictionServer``) takes ``device=`` and defaults to ``"cuda"``.  A host
without CUDA raises instead of running on the CPU: only a caller that asks
for ``device="cpu"`` (the CPU tests do) gets the plain versions.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` (a string or ``torch.device``) as a ``torch.device``;
    raises ``RuntimeError`` for a CUDA device on a host without CUDA."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but CUDA is not available; "
            "pass device='cpu' to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r} (cuda or cpu)")
    return dev
