"""VAE reparameterization ("sample") layer on tensors.

The port's counterpart of ``lightctr_tpu/nn/sample.py`` (a redesign of
``train/layer/sampleLayer.h``): the input is [mu, log(sigma^2)]
(sampleLayer.h:49-52); forward draws

    z = mu + exp(0.5 * log_sigma2) * eps ,  eps ~ N(0, 1)   (sampleLayer.h:58)

and the KL to the standard normal is an explicit loss term
(sampleLayer.h:54-56).  :func:`sample` draws ``eps`` from a
``torch.Generator`` where the JAX function takes a key; the step from
``eps`` to z is :func:`reparameterize`, so a caller can feed given noise.
"""

from __future__ import annotations

from typing import Tuple

import torch


def split(mu_logsigma2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[..., 2G] -> (mu [..., G], log_sigma2 [..., G])."""
    g = mu_logsigma2.shape[-1] // 2
    return mu_logsigma2[..., :g], mu_logsigma2[..., g:]


def reparameterize(mu: torch.Tensor, log_sigma2: torch.Tensor,
                   eps: torch.Tensor) -> torch.Tensor:
    return mu + torch.exp(0.5 * log_sigma2) * eps


def sample(generator: torch.Generator, mu: torch.Tensor,
           log_sigma2: torch.Tensor) -> torch.Tensor:
    """z with eps ~ N(0, 1) drawn from ``generator`` (on its device)."""
    eps = torch.randn(mu.shape, generator=generator, dtype=mu.dtype,
                      device=generator.device)
    return reparameterize(mu, log_sigma2, eps)


def kl_divergence(mu: torch.Tensor, log_sigma2: torch.Tensor
                  ) -> torch.Tensor:
    """KL(N(mu, sigma^2) || N(0, 1)) summed over the gaussian dims, per
    row."""
    return 0.5 * torch.sum(torch.exp(log_sigma2) - (1.0 + log_sigma2)
                           + mu * mu, dim=-1)
