"""PCA via Sanger's rule (the Generalized Hebbian Algorithm) and
principal-component removal, on tensors.

The port's counterpart of ``lightctr_tpu/ops/pca.py`` (a redesign of
``util/pca.h``): the reference trains projection rows with Sanger's rule
over streamed samples (PCA::Train, pca.h:34-61), and offers
``reduceDimension`` and ``remove_pc`` (subtract the projections onto the
top components, the SIF embedding postprocess, pca.h:71-82).

:func:`fit_gha` runs the batched Sanger updates as a loop on the device
(the JAX package's ``lax.scan``); :func:`fit_svd` is the exact path
(``torch.linalg.svd``).  The initial rows come from a ``torch.Generator``
(the JAX package draws them from a JAX key: the two differ from one seed).
The matrix products and the SVD are library calls.
"""

from __future__ import annotations

import numpy as np
import torch

from lightctr_tpu_torch.core.device import resolve_device


def init(generator: torch.Generator, feature_cnt: int, n_components: int,
         device="cuda") -> torch.Tensor:
    """[C, D] unit rows from N(0, 0.1^2) draws of ``generator`` (made on
    its own device), on ``device``."""
    dev = resolve_device(device)
    w = torch.randn((n_components, feature_cnt), generator=generator,
                    device=generator.device, dtype=torch.float32) * 0.1
    w = w.to(dev)
    return w / torch.linalg.norm(w, dim=1, keepdim=True)


def sanger_step(w: torch.Tensor, x: torch.Tensor, lr: float) -> torch.Tensor:
    """One batched Sanger update:  dW = lr * (y^T x - LT(y^T y) W) / B,
    y = x W^T  (pca.h:34-61, vectorized over the batch)."""
    y = x @ w.T                                        # [B, C]
    yyt = y.T @ y                                      # [C, C]
    lower = torch.tril(yyt)
    return w + lr * (y.T @ x - lower @ w) / x.shape[0]


def fit_gha(
    generator: torch.Generator,
    x: np.ndarray,
    n_components: int,
    epochs: int = 100,
    lr: float = 0.01,
    batch_size: int = 64,
    device="cuda",
) -> torch.Tensor:
    """Streaming GHA training on ``device``; returns [C, D] unit rows."""
    dev = resolve_device(device)
    x = np.asarray(x)
    xc = torch.as_tensor(x - x.mean(axis=0, keepdims=True)).to(dev)
    w = init(generator, x.shape[1], n_components, device=dev)
    n = xc.shape[0]
    batch_size = min(batch_size, n)
    steps = n // batch_size
    batches = xc[: steps * batch_size].reshape(steps, batch_size, -1)
    for _ in range(epochs):
        for b in batches:
            w = sanger_step(w, b, lr)
    return w / torch.linalg.norm(w, dim=1, keepdim=True)


def fit_svd(x: np.ndarray, n_components: int, device="cuda") -> torch.Tensor:
    """Exact top components via SVD of the centred rows: [C, D]."""
    dev = resolve_device(device)
    x = np.asarray(x)
    xc = torch.as_tensor(x - x.mean(axis=0, keepdims=True)).to(dev)
    _, _, vt = torch.linalg.svd(xc, full_matrices=False)
    return vt[:n_components]


def reduce_dimension(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Project rows onto the learned components (pca.h reduceDimension)."""
    return x @ w.T


def remove_pc(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Subtract the projections onto the components (pca.h:71-82
    remove_pc)."""
    return x - (x @ w.T) @ w
