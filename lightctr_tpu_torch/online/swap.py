"""Dense-model hot-swap behind a shadow-scoring parity gate, the port's
counterpart of ``lightctr_tpu/online/swap.py``.

The online trainer periodically exports its dense half as a compressed
artifact (``models/export.py``); this module is the serving side of that
hand-off (docs/ONLINE.md): load the candidate, score a HELD replay slice
with the candidate and the live model side by side, and flip
(:meth:`~lightctr_tpu_torch.serve.model.ServingModel.swap_params`, one atomic
reference assignment between micro-batches) only when the two agree
within tolerance.  A corrupted export — torn file, wrong kind, NaN
weights, or weights that simply score differently than any plausible
training step could explain — is REFUSED, counted, and evented; the live
model keeps serving.

The replay slice is captured once, including the PS rows it scored
against for row-backed models, so the gate compares MODELS under
identical inputs — concurrent training churn cannot masquerade as (or
mask) a corrupted export.

Export hand-off protocol (:func:`publish_export` writes it, the watcher
reads it): artifacts are ``tmp -> fsync -> rename`` atomic, and a
``LATEST`` pointer file (same atomic dance) names the newest one — a
reader never sees a torn artifact through the pointer.
"""

from __future__ import annotations

import logging
import os
import threading
from typing import Dict, List, Optional

import numpy as np

from lightctr_tpu_torch.obs import events as events_mod
from lightctr_tpu_torch.obs import gate as obs_gate
from lightctr_tpu_torch.obs.registry import labeled
from lightctr_tpu_torch.serve.model import ServingModel

_LOG = logging.getLogger(__name__)

LATEST_POINTER = "LATEST"


def publish_export(export_dir: str, params: Dict, model: str, step: int,
                   **save_kw) -> str:
    """Write ``model_<step>.npz`` atomically (tmp + fsync dir-entry via
    rename) and flip the ``LATEST`` pointer to it.  Returns the artifact
    path.  ``save_kw`` forwards to
    :func:`lightctr_tpu_torch.models.export.save_compressed_npz`."""
    from lightctr_tpu_torch.models.export import save_compressed_npz

    os.makedirs(export_dir, exist_ok=True)
    name = f"model_{int(step):010d}.npz"
    final = os.path.join(export_dir, name)
    tmp = os.path.join(export_dir, f".tmp_{name}")
    save_compressed_npz(tmp, params, model=model, **save_kw)
    # fsync the ARTIFACT bytes before any rename: the pointer below is
    # durable, so without this a crash could leave a durable LATEST
    # naming a torn artifact — the exact inversion of the guarantee
    with open(tmp, "rb") as f:
        os.fsync(f.fileno())
    os.replace(tmp, final)
    ptr_tmp = os.path.join(export_dir, ".tmp_" + LATEST_POINTER)
    with open(ptr_tmp, "w") as f:
        f.write(name)
        f.flush()
        os.fsync(f.fileno())
    os.replace(ptr_tmp, os.path.join(export_dir, LATEST_POINTER))
    # fsync the directory so both renames (artifact + pointer) survive
    # a crash together
    dirfd = os.open(export_dir, os.O_RDONLY)
    try:
        os.fsync(dirfd)
    finally:
        os.close(dirfd)
    return final


def read_latest(export_dir: str) -> Optional[str]:
    """The artifact path the ``LATEST`` pointer names (None when no
    export has been published yet)."""
    try:
        with open(os.path.join(export_dir, LATEST_POINTER)) as f:
            name = f.read().strip()
    except OSError:
        return None
    return os.path.join(export_dir, name) if name else None


class ModelSwapper:
    """Shadow-scoring swap gate over one live :class:`ServingModel`.

    ``replay``: request-array dicts (the model's batch layout) held as
    the parity probe; for PS-row-backed models pass ``pull_rows(uids) ->
    [n, row_dim] rows`` so the slice can capture its row inputs once.
    ``tolerance``: max absolute score divergence the gate accepts —
    budget it for the export codec (an int8-coded export of the CURRENT
    weights should pass; a corrupted one should not).

    Quality gate (optional, on top of parity): pass ``quality_margin``
    plus replay slices that carry ``labels`` and the gate additionally
    sketches both models' replay scores (obs.quality accumulators) and
    refuses a candidate whose calibration ratio is materially worse
    than the incumbent's (``|log ratio|`` exceeding the incumbent's by
    more than ``log1p(quality_margin)``) or whose sketch-AUC regresses
    by more than ``auc_margin`` — a miscalibrated export (e.g. a
    temperature-scaled head) parity-checks fine score-by-score under a
    loose tolerance but is still the wrong model to promote.  The gate
    arms only when the replay carries at least ``quality_min_count``
    labeled examples.
    """

    def __init__(
        self,
        model: ServingModel,
        replay: List[Dict],
        tolerance: float = 5e-3,
        pull_rows=None,
        registry=None,
        quality_margin: Optional[float] = None,
        auc_margin: float = 0.01,
        quality_min_count: int = 256,
        quality_bins: int = 512,
    ):
        from lightctr_tpu_torch.obs.registry import default_registry

        if not replay:
            raise ValueError("swap gate needs a non-empty replay slice")
        self.model = model
        self.tolerance = float(tolerance)
        self.quality_margin = None if quality_margin is None \
            else float(quality_margin)
        self.auc_margin = float(auc_margin)
        self.quality_min_count = int(quality_min_count)
        self.quality_bins = int(quality_bins)
        self.last_quality: Optional[Dict] = None
        self.registry = registry if registry is not None \
            else default_registry()
        self._lock = threading.Lock()
        self.attempts = 0
        self.accepted = 0
        self.refusals: Dict[str, int] = {}
        self.last_diff: Optional[float] = None
        self.last_path: Optional[str] = None
        self._replay = []
        for arrays in replay:
            if model.row_leaves:
                if pull_rows is None:
                    raise ValueError(
                        "row-backed model: pass pull_rows to capture the "
                        "replay slice's row inputs"
                    )
                uids = model.touched_uids(arrays)
                rows = np.asarray(pull_rows(uids), np.float32).reshape(
                    len(uids), model.row_dim
                )
                self._replay.append((arrays, uids, rows))
            else:
                self._replay.append((arrays, None, None))
        self._watch_thread: Optional[threading.Thread] = None
        self._watch_stop = threading.Event()

    @staticmethod
    def _score(model: ServingModel, arrays, uids, rows) -> np.ndarray:
        if model.row_leaves:
            return model.score_rows(arrays, uids, rows)
        return model.score(arrays)

    # -- the gate ------------------------------------------------------------

    def offer(self, path: str) -> bool:
        """Gate one candidate artifact; True = swapped in.  Never raises
        on a bad artifact — refusing is this method's job."""
        with self._lock:
            self.attempts += 1
            self.last_path = path
            if obs_gate.enabled():
                self.registry.inc("online_swap_attempts_total")
            try:
                from lightctr_tpu_torch.models.export import load_compressed_npz

                cand_params, meta = load_compressed_npz(
                    path, device=self.model.device)
                if meta.get("model") != self.model.kind:
                    return self._refuse(
                        path, "kind",
                        got=meta.get("model"), want=self.model.kind,
                    )
                cand = ServingModel(
                    self.model.kind, cand_params,
                    row_leaves=self.model.row_leaves,
                    row_dim=self.model.row_dim,
                    id_fields=self.model.id_fields,
                    device=self.model.device,
                )
            except Exception as e:  # torn npz surfaces as zlib/OS/Value
                # errors depending on where the truncation lands — ANY
                # load failure is a refusal, never a serving crash
                return self._refuse(path, "load", error=repr(e))
            worst = 0.0
            q_old = q_new = None
            if self.quality_margin is not None:
                from lightctr_tpu_torch.obs import quality as quality_mod

                q_old = quality_mod.QualityAccumulator(self.quality_bins)
                q_new = quality_mod.QualityAccumulator(self.quality_bins)
            try:
                for arrays, uids, rows in self._replay:
                    old = self._score(self.model, arrays, uids, rows)
                    new = self._score(cand, arrays, uids, rows)
                    if not np.all(np.isfinite(new)):
                        return self._refuse(path, "nonfinite")
                    worst = max(worst, float(np.abs(new - old).max()))
                    if q_old is not None and "labels" in arrays:
                        y = np.asarray(
                            arrays["labels"], np.float32).reshape(-1)
                        q_old.update_scores(np.asarray(old)[: len(y)], y)
                        q_new.update_scores(np.asarray(new)[: len(y)], y)
            except Exception as e:
                return self._refuse(path, "score", error=repr(e))
            self.last_diff = worst
            if obs_gate.enabled():
                self.registry.gauge_set("online_swap_shadow_diff", worst)
            # NaN in OLD scores would make `worst` NaN, and `NaN > tol`
            # is False — compare through isfinite so nothing slips past
            if not np.isfinite(worst) or worst > self.tolerance:
                return self._refuse(path, "parity", max_abs_diff=worst)
            if q_old is not None and q_old.count >= self.quality_min_count:
                verdict = self._quality_verdict(q_old, q_new)
                self.last_quality = verdict
                if verdict["refuse"]:
                    return self._refuse(path, "quality", **{
                        k: v for k, v in verdict.items() if k != "refuse"
                    })
            version = self.model.swap_params(cand.params)
            self.accepted += 1
            if obs_gate.enabled():
                self.registry.inc("online_swap_accepted_total")
            events_mod.emit("model_swap", path=path, accepted=True,
                            version=version, max_abs_diff=worst)
            _LOG.info("model swap accepted: %s (v%d, max|d|=%.2e)",
                      path, version, worst)
            return True

    def _quality_verdict(self, q_old, q_new) -> Dict:
        """Candidate-vs-incumbent quality comparison over the SAME replay
        scores the parity gate just produced.  Calibration is compared in
        log-ratio space (symmetric over/under-prediction); AUC through
        the rank statistic over the sketch histograms."""
        import math

        def _dev(ratio: float) -> float:
            if not np.isfinite(ratio) or ratio <= 0.0:
                return float("inf")
            return abs(math.log(ratio))

        old_ratio = q_old.calibration_ratio()
        new_ratio = q_new.calibration_ratio()
        old_auc = q_old.auc()
        new_auc = q_new.auc()
        old_ece = q_old.ece()
        new_ece = q_new.ece()
        # two calibration probes: the global ratio (gross bias) in
        # symmetric log space, and per-bucket ECE (shape miscalibration
        # — a temperature-scaled head moves ECE while the ratio can sit
        # still); ``quality_margin`` is the slack for both
        cal_budget = _dev(old_ratio) + math.log1p(self.quality_margin)
        cal_bad = _dev(new_ratio) > cal_budget
        ece_bad = (np.isfinite(old_ece) and np.isfinite(new_ece)
                   and new_ece > old_ece + self.quality_margin)
        auc_bad = (np.isfinite(old_auc) and np.isfinite(new_auc)
                   and new_auc < old_auc - self.auc_margin)
        def _num(x):  # keep the event-log JSON strict-parseable
            return float(x) if np.isfinite(x) else None

        return {
            "refuse": bool(cal_bad or ece_bad or auc_bad),
            "count": int(q_old.count),
            "incumbent_calibration": _num(old_ratio),
            "candidate_calibration": _num(new_ratio),
            "incumbent_ece": _num(old_ece),
            "candidate_ece": _num(new_ece),
            "incumbent_auc": _num(old_auc),
            "candidate_auc": _num(new_auc),
        }

    def _refuse(self, path: str, reason: str, **detail) -> bool:
        self.refusals[reason] = self.refusals.get(reason, 0) + 1
        if obs_gate.enabled():
            self.registry.inc(labeled(
                "online_swap_refused_total", reason=reason,
            ))
        events_mod.emit("model_swap", path=path, accepted=False,
                        reason=reason, **detail)
        _LOG.warning("model swap REFUSED (%s): %s %s", reason, path, detail)
        return False

    # -- export-dir watcher --------------------------------------------------

    def watch(self, export_dir: str, poll_s: float = 0.5) -> None:
        """Poll ``export_dir``'s ``LATEST`` pointer on a daemon thread and
        offer every new artifact to the gate."""
        if self._watch_thread is not None:
            raise RuntimeError("already watching")
        self._watch_stop.clear()

        def loop():
            offered = None
            while not self._watch_stop.is_set():
                path = read_latest(export_dir)
                if path is not None and path != offered:
                    offered = path
                    self.offer(path)
                self._watch_stop.wait(poll_s)

        self._watch_thread = threading.Thread(
            target=loop, daemon=True, name="swap-watcher",
        )
        self._watch_thread.start()

    def stop_watch(self) -> None:
        if self._watch_thread is None:
            return
        self._watch_stop.set()
        self._watch_thread.join(timeout=5.0)
        self._watch_thread = None

    close = stop_watch

    # -- reads ---------------------------------------------------------------

    def stats(self) -> Dict:
        with self._lock:
            return {
                "attempts": self.attempts,
                "accepted": self.accepted,
                "refusals": dict(self.refusals),
                "last_diff": self.last_diff,
                "last_path": self.last_path,
                "model_version": self.model.version,
                "tolerance": self.tolerance,
                "last_quality": self.last_quality,
            }
