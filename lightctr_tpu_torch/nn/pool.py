"""Max pooling on tensors.

The port's counterpart of ``lightctr_tpu/nn/pool.py`` (a redesign of
``train/layer/poolingLayer.h``, whose argmax mask routes the backward
unpooling, poolingLayer.h:81-103): ``F.max_pool2d``, whose backward routes
each window's gradient to its argmax (the first one on a tie).  The layout
is the JAX package's, [N, H, W, C].
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def max_pool(x: torch.Tensor, window: int,
             stride: Optional[int] = None) -> torch.Tensor:
    """[N, H, W, C] -> [N, H/w, W/w, C]; non-overlapping by default
    (Pool_Config{2}, train_cnn_algo.h:42)."""
    stride = stride if stride is not None else window
    y = F.max_pool2d(x.permute(0, 3, 1, 2), window, stride)
    return y.permute(0, 2, 3, 1)
