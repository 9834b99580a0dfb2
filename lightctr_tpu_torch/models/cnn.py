"""LeNet-style CNN classifier on tensors.

The port's counterpart of ``lightctr_tpu/models/cnn.py`` (capability
parity with ``Train_CNN_Algo``, train_cnn_algo.h:37-71), for 28x28 inputs:

  Conv(5x5, 1->6,  stride 2)          -> 12x12x6   (tanh)
  MaxPool(2)                          -> 6x6x6
  Conv(3x3, 6->16, LeNet 6x16 mask)   -> 4x4x16    (tanh)
  Conv(3x3, 16->20)                   -> 2x2x20    (tanh)
  flatten in NHWC order               -> 80
  FC(80 -> hidden) (tanh), FC(hidden -> classes)

Activations are [N, H, W, C] as in the JAX package, so the flatten feeds
``fc1`` the same 80 inputs in the same order and the JAX weights carry
across as they are.
"""

from __future__ import annotations

from typing import Dict

import torch

from lightctr_tpu_torch.nn import conv, dense, pool


def init(generator: torch.Generator, hidden: int = 200, n_classes: int = 10,
         device="cpu") -> Dict:
    return {
        "conv1": conv.init(generator, 5, 1, 6, device=device),
        "conv2": conv.init(generator, 3, 6, 16, device=device),
        "conv3": conv.init(generator, 3, 16, 20, device=device),
        "fc1": dense.init(generator, 20 * 2 * 2, hidden, scale="fan_in",
                          device=device),
        "fc2": dense.init(generator, hidden, n_classes, scale="fan_in",
                          device=device),
    }


def logits(params: Dict, feats: torch.Tensor) -> torch.Tensor:
    """feats: [B, 784] flattened 28x28 (dl_algo_abst.h dense CSV rows)."""
    x = feats.reshape(-1, 28, 28, 1)
    x = conv.apply(params["conv1"], x, stride=2, activation=torch.tanh)
    x = pool.max_pool(x, 2)
    # the static LeNet connectivity (convLayer.h:18-25): a constant, so
    # masked links get zero weight and zero gradient
    mask = torch.as_tensor(conv.LENET_CONNECTION_6x16, device=x.device)
    x = conv.apply(params["conv2"], x, connection_mask=mask,
                   activation=torch.tanh)
    x = conv.apply(params["conv3"], x, activation=torch.tanh)
    x = x.reshape(x.shape[0], -1)
    x = dense.apply(params["fc1"], x, activation=torch.tanh)
    return dense.apply(params["fc2"], x)
