"""Trainer for the deep-learning family (CNN / RNN classifiers).

The port's counterpart of ``lightctr_tpu/models/dl_trainer.py`` (a
redesign of ``DL_Algo_Abst::Train``, dl_algo_abst.h:56-177): a minibatch
is one step — the loss, its gradient by autograd, the optimizer update —
on the trainer's device, eagerly.  The minibatch order is the JAX
package's (``data.batching.minibatches``, numpy-seeded), so from the same
weights the trajectory is the JAX trainer's.

Loss parity: ``loss="square"`` is the reference's Square loss on softmax
outputs (main.cpp:198,216); the default is softmax cross-entropy
(``Logistic_Softmax``, loss.h:65-86).

The JAX ``fit_steps_scan`` runs a step schedule as one ``lax.scan``; here
it is the same loop as ``fit_steps_loop`` (there is no compiled program to
amortise), and ``warmup_steps_scan`` runs it once on copies.
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from lightctr_tpu_torch import obs
from lightctr_tpu_torch.core.config import TrainConfig
from lightctr_tpu_torch.core.device import resolve_device
from lightctr_tpu_torch.data.batching import minibatches
from lightctr_tpu_torch.models._common import (check_batch_size,
                                               default_dl_optimizer,
                                               tree_copy)
from lightctr_tpu_torch.models.ctr_trainer import (grads_of,
                                                   leaves_requiring_grad)
from lightctr_tpu_torch.ops import losses as losses_lib
from lightctr_tpu_torch.ops.activations import softmax
from lightctr_tpu_torch.optim import updaters as optim_lib

_LOG = logging.getLogger(__name__)


def classification_loss(loss_name: str, z: torch.Tensor,
                        onehot: torch.Tensor) -> torch.Tensor:
    """Per-row class-summed loss, batch-averaged (both modes alike)."""
    if loss_name == "softmax_ce":
        return losses_lib.softmax_cross_entropy(z, onehot, reduction="mean")
    if loss_name == "square":
        per_row = torch.sum(losses_lib.square_loss(
            softmax(z), onehot, reduction="none"), dim=-1)
        return torch.mean(per_row)
    raise ValueError(f"unknown loss {loss_name!r}")


def grad_step(loss_fn: Callable, tx, params, opt_state, *args):
    """One update: ``loss_fn(params, *args)``, its gradient by autograd
    (zeros where the loss does not reach a leaf, as ``jax.grad`` gives),
    then ``tx``.  Returns (params, opt_state, loss) with a detached
    loss."""
    leaves = leaves_requiring_grad(params)
    loss = loss_fn(leaves, *args)
    loss.backward()
    grads = grads_of(leaves)
    with torch.no_grad():
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optim_lib.apply_updates(params, updates)
    return params, opt_state, loss.detach()


class ClassifierTrainer:
    """Multiclass trainer over ``logits_fn(params, feats) -> [B, classes]``.
    ``params`` (a tree of tensors) are copied onto ``device`` (``cuda`` by
    default; it raises without CUDA)."""

    def __init__(self, params, logits_fn: Callable, cfg: TrainConfig,
                 n_classes: int, loss: str = "softmax_ce", optimizer=None,
                 device="cuda"):
        self.cfg = cfg
        self.logits_fn = logits_fn
        self.n_classes = n_classes
        self.loss_name = loss
        self.device = resolve_device(device)
        self.tx = optimizer or default_dl_optimizer(cfg)
        self.reset(params)

    def _put(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a)).to(self.device)

    def _loss(self, params, feats, labels):
        z = self.logits_fn(params, feats)
        onehot = F.one_hot(labels.to(torch.int64), self.n_classes).to(z.dtype)
        return classification_loss(self.loss_name, z, onehot)

    def _step(self, feats, labels):
        self.params, self.opt_state, loss = grad_step(
            self._loss, self.tx, self.params, self.opt_state, feats, labels)
        return loss

    def fit(self, features: np.ndarray, labels: np.ndarray,
            epochs: Optional[int] = None, batch_size: Optional[int] = None,
            verbose: bool = False) -> Dict[str, list]:
        epochs = epochs if epochs is not None else self.cfg.epochs
        batch_size = batch_size if batch_size is not None \
            else self.cfg.minibatch_size
        check_batch_size(len(features), batch_size)
        arrays = {"x": features, "y": labels}
        history = {"loss": []}
        t0 = time.perf_counter()
        for epoch in range(epochs):
            loss = None
            for b in minibatches(arrays, batch_size,
                                 seed=self.cfg.seed + epoch):
                loss = self._step(self._put(b["x"]), self._put(b["y"]))
            history["loss"].append(float(loss))
            obs.emit_event("epoch", epoch=epoch, loss=float(loss))
            if verbose:
                obs.ensure_console_logging()
                _LOG.info("epoch %d: loss=%.5f", epoch, float(loss))
        history["wall_time_s"] = time.perf_counter() - t0
        return history

    def reset(self, params) -> None:
        """Fresh (params, opt_state) from ``params`` (copied)."""
        self.params = tree_copy(optim_lib.tree_map(
            lambda x: torch.as_tensor(x).to(self.device), params))
        self.opt_state = self.tx.init(self.params)

    def fit_steps_loop(self, features, labels, steps: int, batch_size: int,
                       seed: int = 0, idx=None) -> np.ndarray:
        """``steps`` updates on a host-drawn [steps, batch] schedule of
        rows (``idx`` overrides the seeded one), each step gathering its
        rows on the device; returns the loss trajectory."""
        if idx is None:
            idx = np.random.default_rng(seed).integers(
                0, len(features), size=(steps, batch_size))
        idx = torch.as_tensor(np.asarray(idx)).to(self.device, torch.int64)
        feats = torch.as_tensor(features).to(self.device)
        labs = torch.as_tensor(labels).to(self.device)
        losses = [self._step(feats.index_select(0, idx[i]),
                             labs.index_select(0, idx[i]))
                  for i in range(steps)]
        return torch.stack(losses).cpu().numpy()

    def fit_steps_scan(self, features, labels, steps: int, batch_size: int,
                       seed: int = 0, idx=None) -> np.ndarray:
        """The JAX trainer's on-device scan of the schedule: here the same
        loop as :meth:`fit_steps_loop`, so the two give one trajectory."""
        return self.fit_steps_loop(features, labels, steps, batch_size,
                                   seed=seed, idx=idx)

    def warmup_steps_scan(self, features, labels, steps: int,
                          batch_size: int) -> None:
        """Run the seed-0 schedule once on copies of (params, opt_state)
        and leave the trainer's own untouched."""
        params, state = self.params, self.opt_state
        self.params, self.opt_state = tree_copy(params), tree_copy(state)
        try:
            self.fit_steps_loop(features, labels, steps, batch_size)
        finally:
            self.params, self.opt_state = params, state

    def _logits(self, features) -> torch.Tensor:
        with torch.no_grad():
            return self.logits_fn(self.params, self._put(features))

    def predict(self, features: np.ndarray) -> np.ndarray:
        return torch.argmax(self._logits(features), dim=-1).cpu().numpy()

    def evaluate(self, features: np.ndarray, labels: np.ndarray,
                 batch_size: Optional[int] = None) -> Dict[str, float]:
        """Loss + accuracy report (dl_algo_abst.h:132-177 validate); the
        loss is the trainer's own objective.  ``batch_size`` streams in
        chunks, the tail remainder included."""
        n = len(features)
        if batch_size is not None and batch_size < 1:
            raise ValueError(f"batch_size must be positive, got {batch_size}")
        step = n if batch_size is None or batch_size >= n else batch_size
        loss_sum, correct = 0.0, 0.0
        with torch.no_grad():
            for s in range(0, n, step):
                z = self._logits(features[s: s + step])
                ly = self._put(labels[s: s + step]).to(torch.int64)
                m = z.shape[0]
                onehot = F.one_hot(ly, self.n_classes).to(z.dtype)
                loss = float(classification_loss(self.loss_name, z, onehot))
                hit = (torch.argmax(z, -1) == ly).to(torch.float32)
                if step == n:
                    return {"loss": loss, "accuracy": float(hit.mean())}
                loss_sum += loss * m
                correct += float(hit.sum())
        return {"loss": loss_sum / n, "accuracy": correct / n}
