"""Training configuration, copied from ``lightctr_tpu/core/config.py``.

The reference keeps hyper-parameters as process-wide mutable statics defined in
``main.cpp:64-73`` (``__global_minibatch_size``, ``__global_learning_rate``,
``__global_ema_rate``, ``__global_sparse_rate``, ``__global_lambdaL2``,
``__global_lambdaL1``, momentum statics in ``util/momentumUpdater.h:14-20``)
plus a train/predict phase flag ``__global_bTraining``.

Here that becomes one immutable dataclass that is threaded explicitly through
model constructors and trainer steps.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Global hyper-parameters (reference: ``main.cpp:64-73``).

    Defaults follow the reference's recommended configs (``main.cpp:56-62``):
    FM/FFM/NFM batch=50 lr=0.1; VAE/CNN batch=10 lr=0.1; RNN batch=10 lr=0.03.
    """

    minibatch_size: int = 50
    learning_rate: float = 0.1
    # EMA decay used by RMSprop/Adadelta (reference __global_ema_rate).
    ema_rate: float = 0.9
    # Probability of keeping a unit under dropout (reference __global_sparse_rate
    # is the *drop* rate; we store keep_prob = 1 - sparse_rate for clarity).
    keep_prob: float = 1.0
    lambda_l2: float = 0.001
    lambda_l1: float = 0.0
    # Momentum statics (momentumUpdater.h:14-20).
    momentum: float = 0.9
    momentum_adam2: float = 0.999
    # Numerical floor used throughout the reference updaters.
    eps: float = 1e-7
    # Gradient clipping threshold used by FC / LSTM layers
    # (fullyconnLayer.h:129-131, lstm_unit.h grad clip 15).
    grad_clip: Optional[float] = 15.0
    # Epochs / loop counts.
    epochs: int = 200
    # Precision: compute dtype for matmul-heavy paths ("bfloat16" | "float32").
    compute_dtype: str = "float32"
    # PRNG seed.
    seed: int = 0

    @property
    def sparse_rate(self) -> float:
        """Drop probability, reference naming (main.cpp:68)."""
        return 1.0 - self.keep_prob

    def replace(self, **kw) -> "TrainConfig":
        return dataclasses.replace(self, **kw)
