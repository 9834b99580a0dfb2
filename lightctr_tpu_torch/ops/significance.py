"""Statistical significance helpers.

The port's counterpart of ``lightctr_tpu/ops/significance.py``
(``util/significance.h``: erf, standard and custom normal CDF, inverse
CDF, z-value, significance.h:16-72).  The reference hand-rolls an erf
polynomial and a binary-search inverse; ``torch.special`` has the exact
functions.
"""

from __future__ import annotations

import math

import torch


def erf(x: torch.Tensor) -> torch.Tensor:
    return torch.special.erf(x)


def normal_cdf(x: torch.Tensor, mu: float = 0.0,
               sigma: float = 1.0) -> torch.Tensor:
    """StandardNormalCDF / NormalCDF (significance.h:28-44)."""
    return 0.5 * (1.0 + torch.special.erf((x - mu)
                                          / (sigma * math.sqrt(2.0))))


def inverse_normal_cdf(p: torch.Tensor, mu: float = 0.0,
                       sigma: float = 1.0) -> torch.Tensor:
    """Inverse CDF of N(mu, sigma^2) at ``p`` (the reference binary-searches
    the CDF, significance.h:46-64; ``ndtri`` is the closed form)."""
    return mu + sigma * torch.special.ndtri(p)


def z_value(confidence: float) -> float:
    """Two-sided z for a confidence level (significance.h:66-72), computed
    in float32 as the JAX function's default dtype does."""
    p = torch.tensor(0.5 + confidence / 2.0, dtype=torch.float32)
    return float(inverse_normal_cdf(p))
