"""Gradient-boosted regression trees (XGBoost-style second order) on
tensors.

The port's counterpart of ``lightctr_tpu/models/gbm.py`` (capability parity
with ``GBM_Algo_Abst`` + ``Train_GBM_Algo``): histogram split finding.

  1. features are quantile-binned once on the host (bin 0 = missing);
  2. per tree level, grad/hess histograms over (node, feature, bin) are
     segment sums of the N*F (row, feature) slots: ``merge_rows`` at d 1,
     whose plain version is ``segment_sum`` bit for bit and whose kernel
     on the card sums each segment in slot order.  ``index_add_`` on a
     CUDA tensor sums with atomics in no fixed order, and the splits are
     an argmax over gains built from these sums, so the trees would change
     from run to run; here they repeat bit for bit;
  3. prefix sums over the bins give every candidate split's left/right
     stats, in the order XLA's CPU backend computes ``jnp.cumsum`` (a
     scan of 16-wide blocks, :func:`xla_cumsum`), so from equal histograms
     the gains, and the trees, are the JAX package's;
  4. the best (feature, bin, missing side) per node is ``torch.argmax``
     (the first maximum, as ``jnp.argmax``).

Semantics as in the JAX package: gain = TL1(G, l)^2 / (H + l), leaf weight
-TL1(G, l) / (H + l) (train_gbm_algo.h:94-103); a split only when the
children beat the parent, with the min-leaf-hessian guard; sibling
subtraction below the root (right = parent - left); logistic or softmax
(K trees a round, h = 2 p (1-p)) gradients; row and feature masks drawn by
numpy from ``cfg.seed`` (train_gbm_algo.h:72-86), so from the same data
the trees are the JAX package's.

Trees are arrays (children of i at 2i+1 / 2i+2); prediction is
``max_depth`` gather-and-route steps.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from lightctr_tpu_torch import obs
from lightctr_tpu_torch.core.device import resolve_device
from lightctr_tpu_torch.ops import sparse_kernels
from lightctr_tpu_torch.ops.activations import sigmoid

_LOG = logging.getLogger(__name__)

#: XLA's CPU backend computes a cumulative sum in blocks of this many
#: elements (each block scanned in order, then the block totals)
XLA_SCAN_BLOCK = 16


@dataclasses.dataclass(frozen=True)
class GBMConfig:
    n_trees: int = 10
    max_depth: int = 6
    n_bins: int = 32
    lambda_: float = 1e-5          # train_gbm_algo.cpp:15
    shrinkage: float = 0.6         # train_gbm_algo.cpp:16 "learning_rate"
    row_subsample: float = 0.7     # train_gbm_algo.h:76
    feature_subsample: float = 0.7  # train_gbm_algo.h:83
    min_leaf_hess: float = 1.0     # ctor arg minLeafHess (main.cpp:167)
    n_classes: int = 1             # 1 = binary logistic; >1 = softmax
    seed: int = 0


class Tree(NamedTuple):
    feature: torch.Tensor       # [nodes] int32, -1 for leaf
    threshold: torch.Tensor     # [nodes] int32: real bins 1..thr go left
    weight: torch.Tensor        # [nodes] f32 leaf weight
    default_left: torch.Tensor  # [nodes] bool: where missing (bin 0) goes


def apply_bins(edges: np.ndarray, x: np.ndarray) -> np.ndarray:
    """Encode features against per-feature quantile edges; bin 0 is
    missing (NaN), real values land in [1, n_bins]."""
    bins = np.zeros(x.shape, np.int32)
    nan_mask = np.isnan(x)
    xx = np.nan_to_num(x, nan=0.0)
    for f in range(x.shape[1]):
        bins[:, f] = np.searchsorted(edges[:, f], xx[:, f], side="left") + 1
    bins[nan_mask] = 0
    return bins.astype(np.int32)


def quantile_bins(x: np.ndarray, n_bins: int) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side one-time binning: per-feature quantile edges -> codes in
    [0, n_bins] where 0 = missing (see apply_bins)."""
    qs = np.linspace(0, 100, n_bins + 1)[1:-1]
    edges = np.nanpercentile(x, qs, axis=0)            # [n_bins-1, F]
    return apply_bins(edges, x), edges


def _threshold_l1(g: torch.Tensor, lam: float) -> torch.Tensor:
    """ThresholdL1 (train_gbm_algo.h:100-103)."""
    return torch.sign(g) * torch.clamp(g.abs() - lam, min=0.0)


def _scan_in_order(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sums along the last axis, one add at a time from
    the first element (``torch.cumsum`` accumulates in float64 on the CPU
    and in parallel on the card)."""
    out = [x[..., 0]]
    for k in range(1, x.shape[-1]):
        out.append(out[-1] + x[..., k])
    return torch.stack(out, dim=-1)


def xla_cumsum(x: torch.Tensor) -> torch.Tensor:
    """``jnp.cumsum(x, axis=-1)`` as XLA's CPU backend rounds it: each
    block of XLA_SCAN_BLOCK elements scanned in order, the blocks'
    totals scanned likewise, and each block's exclusive prefix added to
    its own scan."""
    n = x.shape[-1]
    b = XLA_SCAN_BLOCK
    if n <= b:
        return _scan_in_order(x)
    nb = -(-n // b)
    pad = x.new_zeros(x.shape[:-1] + (nb * b - n,))
    blocks = torch.cat([x, pad], dim=-1).reshape(x.shape[:-1] + (nb, b))
    inner = _scan_in_order(blocks)
    totals = xla_cumsum(inner[..., -1])
    out = torch.cat([inner[..., :1, :],
                     inner[..., 1:, :] + totals[..., :-1, None]], dim=-2)
    return out.reshape(x.shape[:-1] + (nb * b,))[..., :n]


def segment_sum(values: torch.Tensor, seg: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """``jax.ops.segment_sum`` of a [n] vector through ``merge_rows`` at
    d 1 (slot order; the kernel on the card)."""
    return sparse_kernels.merge_rows(
        values.reshape(-1, 1).contiguous(), seg.reshape(-1).to(torch.int32),
        num_segments).reshape(num_segments)


def build_tree(bins: torch.Tensor, grad: torch.Tensor, hess: torch.Tensor,
               row_mask: torch.Tensor, feat_mask: torch.Tensor,
               max_depth: int, n_bins: int, lambda_: float,
               min_leaf_hess: float) -> Tree:
    """One tree over ``bins`` [N, F] (int), ``grad`` / ``hess`` /
    ``row_mask`` [N] and ``feat_mask`` [F], on their device: the JAX
    ``build_tree``, with its histograms and leaf sums on ``merge_rows``."""
    with torch.no_grad():
        return _build_tree(bins, grad, hess, row_mask, feat_mask, max_depth,
                           n_bins, lambda_, min_leaf_hess)


def _hist(stat: torch.Tensor, seg: torch.Tensor, mask: torch.Tensor,
          n_groups: int, n_slots: int) -> torch.Tensor:
    """[n_groups, F, n_slots] sums of ``stat * mask`` over the [N, F]
    slots' segments ``seg``: one ``merge_rows`` of N*F slots."""
    n, f = seg.shape
    rep = (stat[:, None] * mask).expand(n, f).reshape(-1)
    return segment_sum(rep, seg.reshape(-1), n_groups * f * n_slots
                       ).reshape(n_groups, f, n_slots)


def _slots(bins: torch.Tensor, n_slots: int) -> torch.Tensor:
    """Each (row, feature) slot's offset in a node's [F, n_slots] block."""
    f = bins.shape[1]
    return torch.arange(f, device=bins.device)[None, :] * n_slots \
        + bins.to(torch.int64)


def root_histograms(bins: torch.Tensor, grad: torch.Tensor,
                    hess: torch.Tensor, row_mask: torch.Tensor,
                    n_bins: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The root's grad and hess histograms [1, F, n_bins + 1] (bin 0 =
    missing): the first two merges of :func:`build_tree`, N*F slots each
    into F*(n_bins + 1) segments."""
    with torch.no_grad():
        seg = _slots(bins, n_bins + 1)
        amask = (row_mask > 0).to(grad.dtype)[:, None]
        return (_hist(grad * row_mask, seg, amask, 1, n_bins + 1),
                _hist(hess * row_mask, seg, amask, 1, n_bins + 1))


def _build_tree(bins, grad, hess, row_mask, feat_mask, max_depth, n_bins,
                lambda_, min_leaf_hess) -> Tree:
    dev = bins.device
    n, f = bins.shape
    n_slots = n_bins + 1  # slot 0 = missing, 1..n_bins = real bins
    n_nodes = (1 << (max_depth + 1)) - 1
    bins = bins.to(torch.int64)
    feature = torch.full((n_nodes,), -1, dtype=torch.int32, device=dev)
    threshold = torch.zeros((n_nodes,), dtype=torch.int32, device=dev)
    weight = torch.zeros((n_nodes,), dtype=torch.float32, device=dev)
    default_left = torch.zeros((n_nodes,), dtype=torch.bool, device=dev)
    # rows start at node 0; inactive (unsampled) rows get node -1
    node_of_row = torch.where(row_mask > 0, 0, -1).to(torch.int64)
    g = grad * row_mask
    h = hess * row_mask
    slot_of = _slots(bins, n_slots)
    prev_hist_g = prev_hist_h = prev_split = None

    for depth in range(max_depth):
        level_size = 1 << depth
        offset = level_size - 1
        local = node_of_row - offset
        active = (local >= 0) & (local < level_size)
        if depth == 0:
            # root histogram: the only full scatter over all rows
            hist_g, hist_h = root_histograms(bins, grad, hess, row_mask,
                                             n_bins)
        else:
            # sibling subtraction: scatter only the left children (local
            # index 2p), right = parent - left; a parent that became a leaf
            # routed no rows onward, so its children read as zero
            half = level_size // 2
            is_left = active & (local % 2 == 0)
            pidx = torch.where(is_left, local // 2, 0)
            seg = pidx[:, None] * (f * n_slots) + slot_of
            lmask = is_left.to(g.dtype)[:, None]
            left_g = _hist(g, seg, lmask, half, n_slots)
            left_h = _hist(h, seg, lmask, half, n_slots)
            smask = prev_split.to(g.dtype)[:, None, None]
            right_g = prev_hist_g * smask - left_g
            right_h = prev_hist_h * smask - left_h
            hist_g = torch.stack([left_g, right_g], dim=1).reshape(
                level_size, f, n_slots)
            hist_h = torch.stack([left_h, right_h], dim=1).reshape(
                level_size, f, n_slots)
        prev_hist_g, prev_hist_h = hist_g, hist_h

        miss_g = hist_g[..., :1]                                # [L, F, 1]
        miss_h = hist_h[..., :1]
        gl = xla_cumsum(hist_g[..., 1:])                        # [L, F, B]
        hl = xla_cumsum(hist_h[..., 1:])
        gtot = gl[..., -1:] + miss_g                            # node totals
        htot = hl[..., -1:] + miss_h
        tp = _threshold_l1(gtot, lambda_)
        gain_parent = tp * tp / (htot + lambda_)
        feat_ok = feat_mask[None, :, None] > 0

        def split_gain_for(gl_side, hl_side):
            gr = gtot - gl_side
            hr = htot - hl_side
            tl = _threshold_l1(gl_side, lambda_)
            tr = _threshold_l1(gr, lambda_)
            gain = tl * tl / (hl_side + lambda_) + tr * tr / (hr + lambda_) \
                - gain_parent
            ok = (hl_side >= min_leaf_hess) \
                & (htot - hl_side >= min_leaf_hess) & feat_ok
            return torch.where(ok, gain, -torch.inf)

        # sparsity-aware candidates: missing mass routed left OR right
        gain_ml = split_gain_for(gl + miss_g, hl + miss_h)      # [L, F, B]
        gain_mr = split_gain_for(gl, hl)
        split_gain = torch.stack([gain_mr, gain_ml], dim=-1)    # [L,F,B,2]

        flat_gain = split_gain.reshape(level_size, f * n_bins * 2)
        best = torch.argmax(flat_gain, dim=-1)                  # [L]
        best_gain = torch.gather(flat_gain, 1, best[:, None])[:, 0]
        best_f = (best // (n_bins * 2)).to(torch.int32)
        best_b = ((best // 2) % n_bins).to(torch.int32) + 1     # real bin
        best_ml = (best % 2).to(torch.bool)                     # missing left
        do_split = best_gain > 1e-12                            # beats parent
        prev_split = do_split

        node_ids = offset + torch.arange(level_size, device=dev)
        feature[node_ids] = torch.where(do_split, best_f, -1).to(torch.int32)
        threshold[node_ids] = best_b
        default_left[node_ids] = do_split & best_ml
        # per-node totals are feature-independent: feature 0's
        g_node = gtot[:, 0, 0]
        h_node = htot[:, 0, 0]
        wleaf = -_threshold_l1(g_node, lambda_) / (h_node + lambda_)
        weight[node_ids] = torch.where(do_split, 0.0, wleaf)

        # route rows: real bin <= thr -> left; missing -> default direction
        at = node_of_row.clamp(0, n_nodes - 1)
        row_f = feature[at].to(torch.int64)
        row_t = threshold[at]
        row_dl = default_left[at]
        row_bin = torch.gather(bins, 1, row_f.clamp(0, f - 1)[:, None])[:, 0]
        is_internal = active & (row_f >= 0)
        left = torch.where(row_bin == 0, row_dl, row_bin <= row_t)
        child = torch.where(left, 2 * node_of_row + 1, 2 * node_of_row + 2)
        node_of_row = torch.where(is_internal, child, node_of_row)

    # final level: everything still routed is a leaf
    level_size = 1 << max_depth
    offset = level_size - 1
    local = node_of_row - offset
    active = (local >= 0) & (local < level_size)
    seg = torch.where(active, local, level_size)  # overflow slot for the rest
    gsum = segment_sum(g, seg, level_size + 1)[:level_size]
    hsum = segment_sum(h, seg, level_size + 1)[:level_size]
    node_ids = offset + torch.arange(level_size, device=dev)
    weight[node_ids] = -_threshold_l1(gsum, lambda_) / (hsum + lambda_)
    return Tree(feature=feature, threshold=threshold, weight=weight,
                default_left=default_left)


def histogram_merges(max_depth: int) -> int:
    """``merge_rows`` launches of one :func:`build_tree`: grad and hess at
    each level, and the two leaf sums."""
    return 2 * max_depth + 2


def tree_route(tree: Tree, bins: torch.Tensor, max_depth: int
               ) -> torch.Tensor:
    """The resting node index per row: ``max_depth`` gather-and-route
    steps (gbm_algo_abst.h:127-151)."""
    n, f = bins.shape
    bins = bins.to(torch.int64)
    idx = torch.zeros((n,), dtype=torch.int64, device=bins.device)
    for _ in range(max_depth):
        feat = tree.feature[idx].to(torch.int64)
        thr = tree.threshold[idx]
        dl = tree.default_left[idx]
        b = torch.gather(bins, 1, feat.clamp(0, f - 1)[:, None])[:, 0]
        left = torch.where(b == 0, dl, b <= thr)  # missing -> learned side
        child = torch.where(left, 2 * idx + 1, 2 * idx + 2)
        idx = torch.where(feat >= 0, child, idx)
    return idx


def tree_predict(tree: Tree, bins: torch.Tensor, max_depth: int
                 ) -> torch.Tensor:
    return tree.weight[tree_route(tree, bins, max_depth)]


class GBMModel:
    """Boosting loop (Train_GBM_Algo::Train: per round sample rows and
    features, grow K trees for K classes, update predictions with
    shrinkage) on ``device`` (``cuda`` by default; it raises without
    CUDA)."""

    def __init__(self, cfg: GBMConfig, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.trees: List[Tree] = []   # round-major, K per round
        self.edges: np.ndarray | None = None

    def _bins(self, x: np.ndarray) -> torch.Tensor:
        assert self.edges is not None
        return torch.from_numpy(apply_bins(self.edges, x)).to(self.device)

    def _put(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def fit(self, x: np.ndarray, y: np.ndarray,
            verbose: bool = False) -> List[float]:
        cfg = self.cfg
        k = max(1, cfg.n_classes)
        bins_np, self.edges = quantile_bins(x, cfg.n_bins)
        bins = self._put(bins_np)
        n = x.shape[0]
        y = np.asarray(y)
        rng = np.random.default_rng(cfg.seed)
        preds = torch.zeros((n, k), dtype=torch.float32, device=self.device)
        history = []
        onehot = None
        if k > 1:
            onehot = self._put(np.eye(k, dtype=np.float32)[y.astype(int)])
        yj = self._put(y.astype(np.float32))
        grow = (cfg.max_depth, cfg.n_bins, cfg.lambda_, cfg.min_leaf_hess)
        with torch.no_grad():
            for t in range(cfg.n_trees):
                row_mask = self._put(
                    (rng.random(n) < cfg.row_subsample).astype(np.float32))
                feat_mask = self._put(
                    (rng.random(x.shape[1]) < cfg.feature_subsample).astype(
                        np.float32))
                if k == 1:
                    p = sigmoid(preds[:, 0])
                    grad = p - yj                       # train_gbm_algo.h:88-90
                    hess = p * (1.0 - p)                # train_gbm_algo.h:91-93
                    tree = _build_tree(bins, grad, hess, row_mask, feat_mask,
                                       *grow)
                    self.trees.append(tree)
                    preds[:, 0] += cfg.shrinkage * tree_predict(
                        tree, bins, cfg.max_depth)
                    z = preds[:, 0]
                    loss = float(torch.mean(
                        torch.log1p(torch.exp(-z.abs()))
                        + torch.clamp(z, min=0) - z * yj))
                else:
                    p = torch.softmax(preds, dim=-1)
                    grads = p - onehot                  # train_gbm_algo.cpp:80-88
                    hesses = 2.0 * p * (1.0 - p)        # train_gbm_algo.cpp:82
                    for c in range(k):
                        tree = _build_tree(bins, grads[:, c].contiguous(),
                                           hesses[:, c].contiguous(),
                                           row_mask, feat_mask, *grow)
                        self.trees.append(tree)
                        preds[:, c] += cfg.shrinkage * tree_predict(
                            tree, bins, cfg.max_depth)
                    loss = float(-torch.mean(torch.sum(
                        onehot * torch.log_softmax(preds, -1), -1)))
                history.append(loss)
                obs.emit_event("epoch", epoch=t, loss=loss)
                if verbose:
                    obs.ensure_console_logging()
                    _LOG.info("round %d: loss=%.5f", t, loss)
        return history

    def _decision(self, bins: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        k = max(1, cfg.n_classes)
        preds = torch.zeros((bins.shape[0], k), dtype=torch.float32,
                            device=self.device)
        with torch.no_grad():
            for i, tree in enumerate(self.trees):
                preds[:, i % k] += cfg.shrinkage * tree_predict(
                    tree, bins, cfg.max_depth)
        return preds

    def decision_function(self, x: np.ndarray) -> np.ndarray:
        return self._decision(self._bins(x)).cpu().numpy()

    def predict_proba(self, x: np.ndarray) -> np.ndarray:
        z = self._decision(self._bins(x))
        if self.cfg.n_classes <= 1:
            return sigmoid(z[:, 0]).cpu().numpy()
        return torch.softmax(z, dim=-1).cpu().numpy()

    def predict(self, x: np.ndarray) -> np.ndarray:
        z = self.decision_function(x)
        if self.cfg.n_classes <= 1:
            return (z[:, 0] > 0).astype(np.int32)
        return np.argmax(z, axis=1)

    def evaluate(self, x: np.ndarray, y: np.ndarray) -> dict:
        """Logloss / accuracy / AUC report (GBM_Predict parity,
        gbm_predict.cpp:22-44), from one decision pass."""
        from lightctr_tpu_torch.ops import losses as losses_lib
        from lightctr_tpu_torch.ops.metrics import auc_exact, logloss

        y = np.asarray(y)
        zt = self._decision(self._bins(x))
        z = zt.cpu().numpy()
        if self.cfg.n_classes <= 1:
            probs = sigmoid(zt[:, 0]).cpu()
            pred = (z[:, 0] > 0).astype(y.dtype)
            return {
                "accuracy": float((pred == y).mean()),
                "logloss": float(logloss(probs, torch.from_numpy(
                    y.astype(np.float32)))),
                "auc": auc_exact(probs.numpy(), y),
            }
        pred = np.argmax(z, axis=1)
        onehot = torch.from_numpy(np.eye(z.shape[1], dtype=np.float32)[
            y.astype(int)])
        return {
            "accuracy": float((pred == y).mean()),
            "logloss": float(losses_lib.softmax_cross_entropy(
                torch.from_numpy(z), onehot, reduction="mean")),
        }

    def leaf_indices(self, x: np.ndarray) -> np.ndarray:
        """Per-tree leaf index of each row [N, trees], the GBM -> LR
        stacking feature (BASELINE.json config 5)."""
        return self.leaf_indices_of(self._bins(x)).cpu().numpy()

    def leaf_indices_of(self, bins: torch.Tensor) -> torch.Tensor:
        return torch.stack([tree_route(t, bins, self.cfg.max_depth)
                            for t in self.trees], dim=1)
