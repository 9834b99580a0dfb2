"""Diagonal-covariance Gaussian Mixture Model, log-space EM, on tensors.

The port's counterpart of ``lightctr_tpu/models/gmm.py`` (capability parity
with ``Train_GMM_Algo``, train/train_gmm_algo.{h,cpp}).  Each EM iteration
is two batched steps on the device:

  E: log N(x | mu_k, diag sigma_k) for all (row, cluster) at once
     (GaussianLPDF, train_gmm_algo.cpp:45-56), responsibilities via
     logsumexp;
  M: soft counts / weighted moments as products R^T X
     (train_gmm_algo.cpp:84-117), sigma floored at 0.01.

``log_pdf`` builds the [N, K, D] differences (10,000 x 10 x 785 floats is
314 MB).  Init draws from a ``torch.Generator`` where the JAX functions
take a key, so the two packages' inits differ; the EM steps from one init
are the same.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from lightctr_tpu_torch.core.device import resolve_device

LOG_2PI = float(np.log(2.0 * np.pi))
SIGMA_FLOOR = 0.01


class GMMParams(NamedTuple):
    mu: torch.Tensor       # [K, D]
    sigma: torch.Tensor    # [K, D] variances
    weight: torch.Tensor   # [K]


def init(generator: torch.Generator, cluster_cnt: int, feature_cnt: int,
         device="cuda") -> GMMParams:
    """Reference init: mu ~ U(-0.5, 0.5), sigma=5 (train_gmm_algo.cpp:29-42).
    Prefer :func:`init_from_data`."""
    dev = resolve_device(device)
    mu = torch.rand((cluster_cnt, feature_cnt), generator=generator,
                    dtype=torch.float32, device=generator.device) - 0.5
    return GMMParams(
        mu=mu.to(dev),
        sigma=torch.full((cluster_cnt, feature_cnt), 5.0, device=dev),
        weight=torch.full((cluster_cnt,), 1.0 / cluster_cnt, device=dev))


def init_from_data(generator: torch.Generator, cluster_cnt: int,
                   x: np.ndarray, device="cuda") -> GMMParams:
    """Means seeded k-means++-style (each new center drawn in proportion to
    its squared distance from the chosen set), sigma from the data
    variance; on ``device`` (``cuda`` by default; it raises without
    CUDA)."""
    dev = resolve_device(device)
    xj = torch.as_tensor(np.asarray(x, np.float32)).to(dev)
    n = xj.shape[0]
    gdev = generator.device
    first = int(torch.randint(n, (1,), generator=generator, device=gdev))
    centers = [xj[first]]
    d2 = torch.sum((xj - centers[0]) ** 2, dim=1)
    for _ in range(1, cluster_cnt):
        total = torch.sum(d2)
        # all-zero d2 (fewer distinct rows than clusters) -> uniform
        probs = torch.where(total > 1e-12, d2 / torch.clamp(total, min=1e-12),
                            torch.full_like(d2, 1.0 / n))
        idx = int(torch.multinomial(probs.to(gdev), 1, generator=generator))
        centers.append(xj[idx])
        d2 = torch.minimum(d2, torch.sum((xj - centers[-1]) ** 2, dim=1))
    var = torch.clamp(torch.var(xj, dim=0, unbiased=False), min=SIGMA_FLOOR)
    return GMMParams(
        mu=torch.stack(centers),
        sigma=var.expand(cluster_cnt, x.shape[1]).clone(),
        weight=torch.full((cluster_cnt,), 1.0 / cluster_cnt, device=dev))


def log_pdf(params: GMMParams, x: torch.Tensor) -> torch.Tensor:
    """log w_k + log N(x | mu_k, sigma_k) for all rows/clusters -> [N, K]."""
    diff = x[:, None, :] - params.mu[None, :, :]                  # [N, K, D]
    expn = torch.sum(diff * diff / params.sigma[None], dim=-1)     # [N, K]
    log_det = torch.sum(torch.log(params.sigma), dim=-1)           # [K]
    d = x.shape[-1]
    return torch.log(params.weight)[None] - 0.5 * (
        expn + log_det[None] + d * LOG_2PI)


def e_step(params: GMMParams, x: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Responsibilities [N, K] + per-row log-likelihood [N]."""
    lp = log_pdf(params, x)
    norm = torch.logsumexp(lp, dim=-1, keepdim=True)
    return torch.exp(lp - norm), norm[:, 0]


def m_step(params: GMMParams, x: torch.Tensor, resp: torch.Tensor
           ) -> GMMParams:
    soft_cnt = torch.sum(resp, dim=0)                              # [K]
    # starved clusters keep their previous parameters
    safe_cnt = torch.clamp(soft_cnt, min=1e-12)[:, None]
    alive = (soft_cnt > 0)[:, None]
    mu = torch.where(alive, (resp.T @ x) / safe_cnt, params.mu)    # [K, D]
    # sigma against the PREVIOUS mu (train_gmm_algo.cpp:101-106)
    diff = x[:, None, :] - params.mu[None, :, :]
    sigma = torch.where(
        alive, torch.einsum("nk,nkd->kd", resp, diff * diff) / safe_cnt,
        params.sigma)
    sigma = torch.clamp(sigma, min=SIGMA_FLOOR)
    weight = torch.clamp(soft_cnt / x.shape[0], min=1e-12)
    return GMMParams(mu=mu, sigma=sigma, weight=weight)


def em_step(params: GMMParams, x: torch.Tensor):
    """One E+M iteration; returns (params, summed log-likelihood)."""
    with torch.no_grad():
        resp, ll_rows = e_step(params, x)
        return m_step(params, x, resp), torch.sum(ll_rows)


def fit(params: GMMParams, x: np.ndarray, epochs: int = 50,
        tol: float = 1e-3, verbose: bool = False,
        device="cuda") -> Tuple[GMMParams, list]:
    """EM until ELOB convergence, via the shared template (models/em.py),
    on ``device`` (``cuda`` by default; it raises without CUDA)."""
    from lightctr_tpu_torch.models.em import fit_em

    dev = resolve_device(device)
    params = GMMParams(*(t.to(dev) for t in params))
    xj = torch.as_tensor(np.asarray(x, np.float32)).to(dev)
    return fit_em(params, em_step, xj, epochs, tol, verbose, name="GMM")


def predict(params: GMMParams, x: np.ndarray) -> np.ndarray:
    """Hard cluster assignment (Train_GMM_Algo::Predict), on the params'
    device."""
    xj = torch.as_tensor(np.asarray(x, np.float32)).to(params.mu.device)
    with torch.no_grad():
        resp, _ = e_step(params, xj)
    return torch.argmax(resp, dim=-1).cpu().numpy()
