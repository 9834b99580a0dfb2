"""Variational autoencoder on tensors.

The port's counterpart of ``lightctr_tpu/models/vae.py`` (capability
parity with ``Train_VAE_Algo``, train_vae_algo.h:42-109):

  encoder:  FC(feature -> hidden, sigmoid) -> FC(hidden -> 2*gauss)
  sample:   z = mu + exp(0.5 log_sigma2) * eps        (sampleLayer.h:58)
  decoder:  FC(gauss -> hidden, sigmoid) -> FC(hidden -> feature, sigmoid)
  loss:     0.5*|x - x_hat|^2 + kl_weight * KL(N(mu, sigma^2) || N(0,1))

Where the JAX functions take a key, these take the noise ``eps`` (the
forward's draw) or a ``torch.Generator``; :class:`VAETrainer` draws each
step's ``eps`` from a generator seeded with ``cfg.seed`` on its device.
"""

from __future__ import annotations

import logging
import time
from typing import Dict, Optional

import numpy as np
import torch

from lightctr_tpu_torch import obs
from lightctr_tpu_torch.core.config import TrainConfig
from lightctr_tpu_torch.core.device import resolve_device
from lightctr_tpu_torch.data.batching import minibatches
from lightctr_tpu_torch.models._common import (check_batch_size,
                                               default_dl_optimizer,
                                               tree_copy)
from lightctr_tpu_torch.models.dl_trainer import grad_step
from lightctr_tpu_torch.nn import dense, sample
from lightctr_tpu_torch.ops.activations import sigmoid
from lightctr_tpu_torch.optim import updaters as optim_lib

_LOG = logging.getLogger(__name__)


def init(generator: torch.Generator, feature_cnt: int, hidden: int = 60,
         gauss_cnt: int = 20, device="cpu") -> Dict:
    return {
        "enc1": dense.init(generator, feature_cnt, hidden, device=device),
        "enc2": dense.init(generator, hidden, gauss_cnt * 2, device=device),
        "dec1": dense.init(generator, gauss_cnt, hidden, device=device),
        "dec2": dense.init(generator, hidden, feature_cnt, device=device),
    }


def encode_params(params: Dict, x: torch.Tensor):
    h = dense.apply(params["enc1"], x, activation=sigmoid)
    return sample.split(dense.apply(params["enc2"], h))


def decode(params: Dict, z: torch.Tensor) -> torch.Tensor:
    h = dense.apply(params["dec1"], z, activation=sigmoid)
    return dense.apply(params["dec2"], h, activation=sigmoid)


def forward(params: Dict, x: torch.Tensor, eps: torch.Tensor):
    """(x_hat, mu, log_sigma2) with the latent noise ``eps`` [B, gauss]."""
    mu, log_sigma2 = encode_params(params, x)
    z = sample.reparameterize(mu, log_sigma2, eps)
    return decode(params, z), mu, log_sigma2


def loss_fn(params: Dict, x: torch.Tensor, eps: torch.Tensor,
            kl_weight: float) -> torch.Tensor:
    x_hat, mu, log_sigma2 = forward(params, x, eps)
    recon = torch.sum(0.5 * (x_hat - x) ** 2, dim=-1)   # Square loss
    kl = sample.kl_divergence(mu, log_sigma2)
    return torch.mean(recon + kl_weight * kl)


def encode(params: Dict, x: torch.Tensor,
           generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """The latent sample (the reference's ``bEncoding`` path samples too),
    or mu when ``generator`` is None."""
    mu, log_sigma2 = encode_params(params, x)
    if generator is None:
        return mu
    return sample.sample(generator, mu, log_sigma2)


class VAETrainer:
    """Minibatch trainer of the VAE on ``device`` (``cuda`` by default; it
    raises without CUDA)."""

    def __init__(self, params, cfg: TrainConfig, kl_weight: float = 1.0,
                 optimizer=None, device="cuda"):
        self.device = resolve_device(device)
        self.params = tree_copy(optim_lib.tree_map(
            lambda x: torch.as_tensor(x).to(self.device), params))
        self.cfg = cfg
        self.kl_weight = kl_weight
        self.tx = optimizer or default_dl_optimizer(cfg)
        self.opt_state = self.tx.init(self.params)
        self.generator = torch.Generator(device=self.device).manual_seed(
            cfg.seed)

    def _noise(self, rows: int) -> torch.Tensor:
        """The step's eps [rows, gauss] from the trainer's generator."""
        g = self.params["dec1"]["w"].shape[1]
        return torch.randn((rows, g), generator=self.generator,
                           dtype=torch.float32, device=self.device)

    def _loss(self, params, x, eps):
        return loss_fn(params, x, eps, self.kl_weight)

    def fit(self, features: np.ndarray, epochs: Optional[int] = None,
            batch_size: Optional[int] = None,
            verbose: bool = False) -> Dict[str, list]:
        epochs = epochs if epochs is not None else self.cfg.epochs
        batch_size = batch_size if batch_size is not None \
            else self.cfg.minibatch_size
        check_batch_size(len(features), batch_size)
        history = {"loss": []}
        t0 = time.perf_counter()
        for epoch in range(epochs):
            loss = None
            for b in minibatches({"x": features}, batch_size,
                                 seed=self.cfg.seed + epoch):
                x = torch.as_tensor(b["x"]).to(self.device)
                self.params, self.opt_state, loss = grad_step(
                    self._loss, self.tx, self.params, self.opt_state, x,
                    self._noise(x.shape[0]))
            history["loss"].append(float(loss))
            obs.emit_event("epoch", epoch=epoch, loss=float(loss))
            if verbose:
                obs.ensure_console_logging()
                _LOG.info("epoch %d: loss=%.5f", epoch, float(loss))
        history["wall_time_s"] = time.perf_counter() - t0
        return history

    def reconstruct(self, features: np.ndarray, seed: int = 0) -> np.ndarray:
        gen = torch.Generator(device=self.device).manual_seed(seed)
        x = torch.as_tensor(features).to(self.device)
        with torch.no_grad():
            z = encode(self.params, x, gen)
            return decode(self.params, z).cpu().numpy()
