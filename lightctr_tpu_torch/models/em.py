"""Generic EM loop — ``EM_Algo_Abst`` parity.

A copy of ``lightctr_tpu/models/em.py`` (numpy only; the logging import
is the port's).  The reference's EM template method (em_algo_abst.h:33-48)
runs ``Train_EStep`` -> ``Train_MStep`` until the ELOB stops improving;
:mod:`lightctr_tpu_torch.models.gmm` and
:mod:`lightctr_tpu_torch.models.plsa` drive their steps through it.
"""

from __future__ import annotations

import logging

from typing import Callable, List, Tuple

import numpy as np

from lightctr_tpu_torch.obs import ensure_console_logging

_LOG = logging.getLogger(__name__)


def fit_em(
    params,
    step: Callable,  # (params, data) -> (params, loglik)
    data,
    epochs: int = 50,
    tol: float = 1e-3,
    verbose: bool = False,
    name: str = "EM",
) -> Tuple[object, List[float]]:
    """Iterate ``step`` until the log-likelihood's relative improvement drops
    below ``tol`` (em_algo_abst.h:33-48 convergence semantics)."""
    history: List[float] = []
    prev = -np.inf
    for it in range(epochs):
        params, ll = step(params, data)
        ll = float(ll)
        history.append(ll)
        if verbose:
            ensure_console_logging()
            _LOG.info("%s iter %d: loglik=%.4f", name, it, ll)
        if np.isfinite(prev) and abs(ll - prev) < tol * abs(prev):
            break
        prev = ll
    return params, history
