"""GBM leaf-index -> sparse-LR stacked model, on tensors.

The port's counterpart of ``lightctr_tpu/models/stacking.py``
(BASELINE.json config 5, "GBM leaf-index -> FTRL_LR stacked model"):
boosted trees learn feature crossings, each (tree, leaf) pair becomes a
one-hot feature, and a sparse logistic regression (FTRL by default) is
trained on top, full batch, on the GBM's device.

The LR's gather of its weights goes through ``embed.table.lookup``, so its
gradient sums each weight's rows in slot order (``merge_rows`` at d 1 on
the card, one launch a step), as XLA sums the gradient of ``jnp.take``.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional

import numpy as np
import torch

from lightctr_tpu_torch import obs
from lightctr_tpu_torch.embed.table import lookup
from lightctr_tpu_torch.models.dl_trainer import grad_step
from lightctr_tpu_torch.models.gbm import GBMConfig, GBMModel
from lightctr_tpu_torch.ops import losses as losses_lib
from lightctr_tpu_torch.ops.activations import sigmoid
from lightctr_tpu_torch.ops.metrics import auc_exact
from lightctr_tpu_torch.optim import updaters as optim_lib

_LOG = logging.getLogger(__name__)


class GBMLRStack:
    """fit = GBM boosting, then FTRL-LR over one-hot leaf indices, on
    ``device`` (``cuda`` by default; it raises without CUDA)."""

    def __init__(self, gbm_config: Optional[GBMConfig] = None,
                 lr_optimizer=None, lr_steps: int = 200, device="cuda"):
        cfg = gbm_config or GBMConfig()
        if cfg.n_classes > 1:
            raise ValueError(
                "GBMLRStack is a binary-CTR recipe; got n_classes="
                f"{cfg.n_classes} (stacking multiclass leaf features into one "
                "binary logit would silently produce garbage)")
        self.gbm = GBMModel(cfg, device=device)
        self.device = self.gbm.device
        # the reference's FTRL constants (lambda1 = 1) zero one-hot leaf
        # features; these keep the stack sparse and match-or-beat the GBM
        self.tx = lr_optimizer or optim_lib.ftrl(alpha=1.0, lambda1=0.003)
        self.lr_steps = lr_steps
        self.w: Optional[torch.Tensor] = None
        self._n_nodes = 0

    def _leaf_feature_ids(self, x: np.ndarray) -> torch.Tensor:
        leaves = self.gbm.leaf_indices_of(self.gbm._bins(x))     # [N, trees]
        offs = torch.arange(leaves.shape[1], device=leaves.device) \
            * self._n_nodes
        return (leaves + offs[None, :]).to(torch.int32)

    @staticmethod
    def _loss(w, feat_ids, y):
        z = torch.sum(lookup(w, feat_ids), dim=1)
        return losses_lib.logistic_loss(z, y, reduction="mean")

    def fit(self, x: np.ndarray, y: np.ndarray,
            verbose: bool = False) -> Dict[str, List[float]]:
        gbm_hist = self.gbm.fit(x, y, verbose=verbose)
        return {"gbm_loss": gbm_hist, "lr_loss": self.fit_lr(x, y, verbose)}

    def fit_lr(self, x: np.ndarray, y: np.ndarray,
               verbose: bool = False) -> List[float]:
        """The LR half of :meth:`fit` over the fitted GBM's leaves:
        ``lr_steps`` full-batch steps from zero weights; the losses."""
        self._n_nodes = (1 << (self.gbm.cfg.max_depth + 1)) - 1
        feat_ids = self._leaf_feature_ids(x)
        n_features = self._n_nodes * len(self.gbm.trees)
        yj = torch.from_numpy(np.asarray(y, np.float32)).to(self.device)
        w = torch.zeros((n_features,), dtype=torch.float32,
                        device=self.device)
        state = self.tx.init(w)
        losses = []
        for _ in range(self.lr_steps):
            w, state, loss = grad_step(self._loss, self.tx, w, state,
                                       feat_ids, yj)
            losses.append(loss)
        lr_hist = torch.stack(losses).cpu().tolist() if losses else []
        self.w = w
        if verbose:
            obs.ensure_console_logging()
            _LOG.info("LR: loss %.5f -> %.5f", lr_hist[0], lr_hist[-1])
        return lr_hist

    def predict_proba(self, x: np.ndarray) -> np.ndarray:
        if self.w is None:
            raise RuntimeError("fit() first")
        with torch.no_grad():
            z = torch.sum(self.w[self._leaf_feature_ids(x).to(torch.int64)],
                          dim=1)
            return sigmoid(z).cpu().numpy()

    def evaluate(self, x: np.ndarray, y: np.ndarray) -> Dict[str, float]:
        from lightctr_tpu_torch.ops.metrics import logloss

        probs = self.predict_proba(x)
        y = np.asarray(y)
        return {
            "accuracy": float(((probs > 0.5) == (y > 0.5)).mean()),
            "logloss": float(logloss(torch.from_numpy(probs),
                                     torch.from_numpy(y.astype(np.float32)))),
            "auc": auc_exact(probs, y),
            "nonzero_weights": int(torch.count_nonzero(self.w)),
        }
