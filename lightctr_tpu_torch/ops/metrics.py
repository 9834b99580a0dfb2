"""Evaluation metrics on tensors: AUC, accuracy, precision/recall/F1,
logloss.

The port's counterpart of ``lightctr_tpu/ops/metrics.py`` (a redesign of
``LightCTR/util/evaluator.h``).  The AUC is the reference's histogram formulation: scores bucketed
into ``num_bins`` bins on the device, then a trapezoid sweep from the top
bin down on the host in float64 (evaluator.h:61-94):

    auc = sum_i  neg[i] * (cumpos_incl[i] + cumpos_excl[i]) / 2
          over bins i sorted by descending score, normalized by P*N.

The device histograms are int64 here (the JAX package keeps int32 on the
device and folds into host int64 before it could wrap), so
:class:`StreamingAUC` never has to fold mid-stream.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

DEFAULT_BINS = 1 << 20


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def auc_histogram(scores: torch.Tensor, labels: torch.Tensor,
                  num_bins: int = DEFAULT_BINS) -> torch.Tensor:
    """Histogram-bucket AUC (evaluator.h:61-94), ``scores`` in [0, 1]:
    binning on the scores' device, the sweep on the host in float64."""
    pos_h, neg_h = auc_histogram_update(scores, labels, num_bins=num_bins)
    return auc_from_histogram(pos_h, neg_h)


def _auc_batch_hist(scores: torch.Tensor, labels: torch.Tensor,
                    num_bins: int):
    scores = scores.reshape(-1)
    labels = labels.reshape(-1).to(torch.int64)
    idx = torch.clamp((scores * num_bins).to(torch.int32), 0,
                      num_bins - 1).to(torch.int64)
    zeros = torch.zeros((num_bins,), dtype=torch.int64, device=scores.device)
    pos_b = zeros.index_add(0, idx, labels)
    neg_b = zeros.index_add(0, idx, 1 - labels)
    return pos_b, neg_b


def auc_histogram_update(
    scores: torch.Tensor,
    labels: torch.Tensor,
    pos_hist: Optional[torch.Tensor] = None,
    neg_hist: Optional[torch.Tensor] = None,
    num_bins: int = DEFAULT_BINS,
):
    """Accumulate one batch into (pos, neg) histograms — the streaming form
    of ``AucEvaluator::init`` (evaluator.h:61-74)."""
    pos_b, neg_b = _auc_batch_hist(scores, labels, num_bins)
    if pos_hist is not None:
        pos_b = pos_b + pos_hist
    if neg_hist is not None:
        neg_b = neg_b + neg_hist
    return pos_b, neg_b


class StreamingAUC:
    """Epoch-scale streaming AUC: per-batch binning stays on the device
    (no host traffic in the loop); :meth:`result` fetches the two
    histograms once."""

    def __init__(self, num_bins: int = DEFAULT_BINS):
        self.num_bins = num_bins
        self._pos = None
        self._neg = None

    def update(self, scores: torch.Tensor, labels: torch.Tensor) -> None:
        self._pos, self._neg = auc_histogram_update(
            scores, labels, self._pos, self._neg, self.num_bins)

    def result(self) -> float:
        if self._pos is None:  # no updates at all
            return float(auc_from_histogram(
                np.zeros(self.num_bins, np.int64),
                np.zeros(self.num_bins, np.int64)))
        return float(auc_from_histogram(self._pos, self._neg))


def auc_from_histogram(pos_hist, neg_hist) -> torch.Tensor:
    """Trapezoid sweep from the highest-score bin down (evaluator.h:76-94),
    on the host in float64 (a float32 sweep loses count precision once
    cumulative positives pass 2^24)."""
    p = _np(pos_hist)[::-1].astype(np.float64)
    n = _np(neg_hist)[::-1].astype(np.float64)
    cum_pos = np.cumsum(p)
    # trapezoid: width = neg in bin, heights = cum positives before/after bin
    area = float(np.sum(n * (2.0 * cum_pos - p) * 0.5))
    tot_pos, tot_neg = float(cum_pos[-1]), float(n.sum())
    if tot_pos > 0 and tot_neg > 0:
        return torch.tensor(area / (tot_pos * tot_neg), dtype=torch.float32)
    return torch.tensor(0.0, dtype=torch.float32)


def auc_exact(scores, labels) -> float:
    """Exact Mann-Whitney AUC via ranks (oracle for tests; host-side)."""
    scores = _np(scores).astype(np.float64).reshape(-1)
    labels = _np(labels).reshape(-1)
    order = np.argsort(scores, kind="mergesort")
    ranks = np.empty_like(order, dtype=np.float64)
    ranks[order] = np.arange(1, len(scores) + 1)
    # average ranks for ties
    sorted_scores = scores[order]
    i = 0
    while i < len(scores):
        j = i
        while j + 1 < len(scores) and sorted_scores[j + 1] == sorted_scores[i]:
            j += 1
        if j > i:
            ranks[order[i: j + 1]] = 0.5 * (i + 1 + j + 1)
        i = j + 1
    n_pos = labels.sum()
    n_neg = len(labels) - n_pos
    if n_pos == 0 or n_neg == 0:
        return 0.0
    return float((ranks[labels == 1].sum() - n_pos * (n_pos + 1) / 2)
                 / (n_pos * n_neg))


def accuracy(pred_labels: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred_labels == labels).to(torch.float32))


def precision_recall_f1(pred_labels: torch.Tensor, labels: torch.Tensor):
    """Binary P/R/F1 (evaluator.h:20-49 Precision/Recall/F1Score), each a
    0-d float32 tensor; 0 where its denominator is 0."""
    pred = pred_labels.to(torch.bool)
    lab = labels.to(torch.bool)
    tp = torch.sum(pred & lab).to(torch.float32)
    fp = torch.sum(pred & ~lab).to(torch.float32)
    fn = torch.sum(~pred & lab).to(torch.float32)
    zero = torch.zeros((), dtype=torch.float32, device=tp.device)
    precision = torch.where(tp + fp > 0, tp / (tp + fp), zero)
    recall = torch.where(tp + fn > 0, tp / (tp + fn), zero)
    f1 = torch.where(precision + recall > 0,
                     2 * precision * recall / (precision + recall), zero)
    return precision, recall, f1


def logloss(probs: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean logloss as reported by the predictors (fm_predict.cpp:56-61)."""
    p = torch.clamp(probs, 1e-7, 1.0 - 1e-7)
    return -torch.mean(labels * torch.log(p) + (1 - labels) * torch.log1p(-p))
