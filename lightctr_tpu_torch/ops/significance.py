"""Normal-distribution helper of the quantile codec.

The port's copy of ``inverse_normal_cdf`` from
``lightctr_tpu/ops/significance.py`` (the reference binary-searches the
normal CDF, significance.h:46-64; ``ndtri`` is the closed form).  The rest
of that module (z-tests, confidence intervals) is not ported yet.
"""

from __future__ import annotations

import torch


def inverse_normal_cdf(p: torch.Tensor, mu: float = 0.0,
                       sigma: float = 1.0) -> torch.Tensor:
    """Inverse CDF of N(mu, sigma^2) at ``p``."""
    return mu + sigma * torch.special.ndtri(p)
