"""The continuous train side of the online plane: stream -> pull -> grad
-> push, forever — the port's counterpart of
``lightctr_tpu/online/trainer.py``.

The reference's ``Distributed_Algo_Abst`` Wide&Deep worker is exactly this
loop (PAPER.md: pull the touched rows, one gradient step, push — never
stop); :class:`OnlineTrainer` is its repo-native form over the socket PS:

  - the batch stream is any iterator of padded libFFM batch dicts —
    normally ``data.streaming.iter_libffm_batches(loop=True)`` (infinite
    epochs with per-epoch reshuffle) or ``follow=True`` (tail a growing
    file), so training runs indefinitely;
  - the SPARSE half lives in PS rows (the fused ``[w | v]`` /
    ``[w | embed]`` layout serving already reads — ``serve.fm_ps_row_leaves``),
    updated server-side by the store's Adagrad: the
    :class:`~lightctr_tpu_torch.serve.server.PredictionServer` scores from
    the SAME live rows, and every push lands in the write log the
    freshness subscribers ride;
  - the DENSE half (Wide&Deep's MLP) is worker-local (Parallax's split),
    updated with local Adagrad on the host and periodically EXPORTED as a
    compressed artifact (:func:`lightctr_tpu_torch.online.swap.
    publish_export`) for the serving side's shadow-gated hot-swap.

Pulls and pushes are host numpy over the PS client, as in the JAX
package; the gradient runs on ``device`` (the card by default).  It is
computed on the padded unique-row block: id streams pad to a fixed width
(``b * p`` rows, ``mode="edge"``) so the step sees one input signature
(the process compile tracker makes a width leak a ``recompile_storm``
trip), pad slots alias the last real row but are never indexed by a batch
position, so their gradient is exactly zero and the push ships only real
rows.  The model's lookups take their gradient through ``merge_rows``
(slot order), so a step repeats bit for bit on the card.
"""

from __future__ import annotations

import logging
import time
from typing import Dict, Iterable, Optional

import numpy as np
import torch

from lightctr_tpu_torch.core.device import resolve_device
from lightctr_tpu_torch.obs import device as obs_device
from lightctr_tpu_torch.obs import events as events_mod
from lightctr_tpu_torch.obs import gate as obs_gate
from lightctr_tpu_torch.obs import resources as obs_resources

_LOG = logging.getLogger(__name__)


def _stop_requested(stop) -> bool:
    if stop is None:
        return False
    if hasattr(stop, "is_set"):
        return bool(stop.is_set())
    return bool(stop())


def _host32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy().astype(np.float32)
    return np.asarray(x, np.float32)


class OnlineTrainer:
    """Indefinite pull->grad->push loop against a live PS.

    ``ps``: a :class:`~lightctr_tpu_torch.dist.ps_server.PSClient` /
    ``ShardedPSClient`` (row dim must be ``1 + factor_dim``).  ``kind``:
    ``"fm"`` (fully PS-row-resident) or ``"widedeep"`` (PS rows + local
    dense MLP; requires ``field_cnt`` and ``dense_params`` holding the
    ``fc1``/``fc2`` leaves, e.g. from ``widedeep.init``).  ``export_dir``
    + ``export_every``: publish the dense half every N steps (widedeep
    only) through the atomic LATEST-pointer protocol the serving-side
    :class:`~lightctr_tpu_torch.online.swap.ModelSwapper` watches.
    ``device``: where the gradient runs (``"cuda"`` by default; raises
    without CUDA unless ``"cpu"`` is passed).
    """

    def __init__(
        self,
        ps,
        kind: str,
        factor_dim: int,
        field_cnt: Optional[int] = None,
        dense_params: Optional[Dict] = None,
        dense_lr: float = 0.05,
        eps: float = 1e-7,
        worker_id: int = 0,
        export_dir: Optional[str] = None,
        export_every: int = 0,
        export_codec: str = "int8",
        registry=None,
        quality=None,
        drift=None,
        device="cuda",
    ):
        from lightctr_tpu_torch.obs.registry import default_registry

        if kind not in ("fm", "widedeep"):
            raise ValueError(f"unknown online trainer kind {kind!r}")
        if kind == "widedeep":
            if field_cnt is None or dense_params is None:
                raise ValueError(
                    "widedeep needs field_cnt and dense_params (fc1/fc2)"
                )
            # the dense half is host numpy (local Adagrad, as the JAX
            # trainer's), uploaded to the device for each step's gradient
            self.dense = {
                k: {kk: _host32(vv) for kk, vv in v.items()}
                for k, v in dense_params.items()
            }
            self._dense_acc = {
                k: {kk: np.zeros_like(vv) for kk, vv in v.items()}
                for k, v in self.dense.items()
            }
        elif export_every:
            raise ValueError("fm has no dense half to export")
        self.device = resolve_device(device)
        self.ps = ps
        self.kind = kind
        self.factor_dim = int(factor_dim)
        self.row_dim = 1 + self.factor_dim
        self.field_cnt = None if field_cnt is None else int(field_cnt)
        self.dense_lr = float(dense_lr)
        self.eps = float(eps)
        self.worker_id = int(worker_id)
        self.export_dir = export_dir
        self.export_every = int(export_every)
        self.export_codec = export_codec
        self.registry = registry if registry is not None \
            else default_registry()
        self.steps = 0
        self.examples = 0
        self.exports = 0
        self.push_failures = 0
        self.last_loss: Optional[float] = None
        #: seconds spent in each part of the steps so far: the PS pull
        #: (SSP retries included), the gradient step (upload, forward,
        #: backward, download) and the push
        self.phase_seconds = {"pull": 0.0, "step": 0.0, "push": 0.0}
        # model-quality plane (obs.quality): ``quality`` consumes the
        # per-step (probs, labels) pair for calibration/AUC sketches;
        # ``drift`` consumes label-free scores + the already-deduped uid
        # streams for coverage/score-distribution drift.  Both optional.
        self.quality = quality
        self.drift = drift
        self._grads_fn = None  # built at the first step

    # -- gradient programs ---------------------------------------------------

    def _build(self):
        from lightctr_tpu_torch.ops import losses as losses_lib
        from lightctr_tpu_torch.ops.activations import sigmoid

        # quality/drift want the per-example probabilities from the SAME
        # forward pass — return them instead of re-running inference
        aux = self.quality is not None or self.drift is not None

        if self.kind == "fm":
            from lightctr_tpu_torch.models import fm

            def fm_grads(rows, batch):
                rows = rows.detach().requires_grad_()
                params = {"w": rows[:, 0], "v": rows[:, 1:]}
                z = fm.logits(params, batch)
                loss = losses_lib.logistic_loss(
                    z, batch["labels"], reduction="mean")
                loss.backward()
                probs = sigmoid(z.detach()) if aux else None
                return loss.detach(), probs, rows.grad

            # the online loop pads ids to one fixed width precisely so
            # this step sees ONE input signature — the process compile
            # tracker makes a width leak a recompile_storm trip
            self._grads_fn = obs_resources.track_jit("online_grads_fm",
                                                     fm_grads)
        else:
            from lightctr_tpu_torch.models import widedeep

            def wd_grads(w_rows, e_rows, fc1, fc2, batch):
                w_rows, e_rows = (t.detach().requires_grad_()
                                  for t in (w_rows, e_rows))
                fc1 = {k: v.detach().requires_grad_() for k, v in fc1.items()}
                fc2 = {k: v.detach().requires_grad_() for k, v in fc2.items()}
                params = {"w": w_rows, "embed": e_rows,
                          "fc1": fc1, "fc2": fc2}
                z = widedeep.logits(params, batch)
                loss = losses_lib.logistic_loss(
                    z, batch["labels"], reduction="mean")
                loss.backward()
                probs = sigmoid(z.detach()) if aux else None
                grads = (w_rows.grad, e_rows.grad,
                         {k: v.grad for k, v in fc1.items()},
                         {k: v.grad for k, v in fc2.items()})
                return loss.detach(), probs, grads

            self._grads_fn = obs_resources.track_jit(
                "online_grads_widedeep", wd_grads)
        self._aux = aux

    def _to_device(self, x) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

    # -- SSP pull with retry -------------------------------------------------

    def _pull(self, keys: np.ndarray, stop=None) -> Optional[np.ndarray]:
        while True:
            out = self.ps.pull_arrays(
                keys, worker_epoch=self.steps, worker_id=self.worker_id
            )
            if out is not None:
                return out[1]
            if _stop_requested(stop):
                return None
            time.sleep(0.005)  # SSP-withheld: retry (pull.h:63-67)

    # -- one step ------------------------------------------------------------

    def step(self, mb: Dict[str, np.ndarray], stop=None) -> Optional[float]:
        """One pull->grad->push step over a FULL padded batch (stream the
        loop with ``drop_remainder=True`` — the loop/follow modes only
        yield full batches).  Returns the loss, or None when a stop
        request interrupted the SSP retry."""
        if self._grads_fn is None:
            self._build()
        fids = np.asarray(mb["fids"])
        b, p = fids.shape
        t0 = time.perf_counter()
        if self.kind == "fm":
            u = np.unique(fids.reshape(-1).astype(np.int64))
            rows = self._pull(u, stop)
            if rows is None:
                return None
            t1 = time.perf_counter()
            cap = b * p
            u_pad = np.pad(u, (0, cap - len(u)), mode="edge")
            gathered = rows[np.searchsorted(u, u_pad)]
            batch = {
                "fids": np.searchsorted(u, fids).astype(np.int32),
                "vals": mb["vals"], "mask": mb["mask"],
                "labels": mb["labels"],
            }
            rows_t = self._to_device(np.asarray(gathered, np.float32))
            batch_t = {k: self._to_device(v) for k, v in batch.items()}
            loss, probs, g = obs_device.call(
                "online_grads_fm", self._grads_fn, (rows_t, batch_t))
            g_host = g.cpu().numpy()
            loss = float(loss)
            t2 = time.perf_counter()
            ok = self.ps.push_arrays(
                self.worker_id, u, g_host[: len(u)],
                worker_epoch=self.steps,
            )
            self._feed_quality(probs, mb["labels"], {"fids": u})
        else:
            from lightctr_tpu_torch.models.widedeep import \
                field_representatives

            rep, rep_mask = field_representatives(
                fids, np.asarray(mb["fields"]), np.asarray(mb["mask"]),
                self.field_cnt,
            )
            uw = np.unique(fids.reshape(-1).astype(np.int64))
            ue = np.unique(rep.reshape(-1).astype(np.int64))
            keys = np.union1d(uw, ue)
            rows = self._pull(keys, stop)
            if rows is None:
                return None
            t1 = time.perf_counter()
            cap_w, cap_e = b * p, b * self.field_cnt
            iw = np.searchsorted(
                keys, np.pad(uw, (0, cap_w - len(uw)), mode="edge"))
            ie = np.searchsorted(
                keys, np.pad(ue, (0, cap_e - len(ue)), mode="edge"))
            batch = {
                "fids": np.searchsorted(uw, fids).astype(np.int32),
                "rep_fids": np.searchsorted(ue, rep).astype(np.int32),
                "vals": mb["vals"], "mask": mb["mask"],
                "rep_mask": rep_mask, "labels": mb["labels"],
            }
            rows = np.asarray(rows, np.float32)
            wd_args = (
                self._to_device(rows[iw, 0]), self._to_device(rows[ie, 1:]),
                {k: self._to_device(v) for k, v in self.dense["fc1"].items()},
                {k: self._to_device(v) for k, v in self.dense["fc2"].items()},
                {k: self._to_device(v) for k, v in batch.items()},
            )
            loss, probs, (g_w, g_e, g_fc1, g_fc2) = obs_device.call(
                "online_grads_widedeep", self._grads_fn, wd_args)
            g_w, g_e = g_w.cpu().numpy(), g_e.cpu().numpy()
            g_dense = {"fc1": {k: v.cpu().numpy() for k, v in g_fc1.items()},
                       "fc2": {k: v.cpu().numpy() for k, v in g_fc2.items()}}
            loss = float(loss)
            t2 = time.perf_counter()
            G = np.zeros((len(keys), self.row_dim), np.float32)
            G[iw[: len(uw)], 0] = g_w[: len(uw)]
            G[ie[: len(ue)], 1:] = g_e[: len(ue)]
            ok = self.ps.push_arrays(
                self.worker_id, keys, G, worker_epoch=self.steps,
            )
            self._apply_dense(g_dense)
            self._feed_quality(probs, mb["labels"],
                               {"fids": uw, "rep_fids": ue})
        t3 = time.perf_counter()
        ph = self.phase_seconds
        ph["pull"] += t1 - t0
        ph["step"] += t2 - t1
        ph["push"] += t3 - t2
        self.steps += 1
        self.examples += int(mb.get("row_mask", np.ones(b)).sum())
        self.last_loss = loss
        if not ok:
            # a dropped/partial push is the reference's lossy-async
            # semantics, not a crash — but it must be visible
            self.push_failures += 1
        if obs_gate.enabled():
            reg = self.registry
            reg.inc("online_steps_total")
            reg.inc("online_examples_total",
                    int(mb.get("row_mask", np.ones(b)).sum()))
            reg.gauge_set("online_loss", loss)
            if not ok:
                reg.inc("online_push_failures_total")
        if (self.export_every and self.export_dir
                and self.steps % self.export_every == 0):
            self.export()
        return loss

    def _apply_dense(self, grads: Dict) -> None:
        """Local Adagrad over the dense tree (the worker owns its MLP —
        the Parallax split's dense side), on the host in float32 as in
        the JAX package."""
        for leaf, g_tree in grads.items():
            for k, g in g_tree.items():
                g = np.asarray(g, np.float32)
                acc = self._dense_acc[leaf][k]
                acc += g * g
                w = np.asarray(self.dense[leaf][k], np.float32)
                self.dense[leaf][k] = w - self.dense_lr * g / np.sqrt(
                    acc + self.eps
                )

    def _feed_quality(self, probs, labels, fields) -> None:
        """Feed the model-quality plane off this step's artifacts: the
        probabilities of the gradient's own forward and the
        already-deduped uid streams the pull computed anyway."""
        if probs is None:
            return
        try:
            scores = probs.cpu().numpy().astype(np.float32).reshape(-1)
            if self.quality is not None:
                self.quality.update_scores(
                    scores, np.asarray(labels, np.float32).reshape(-1)
                )
            if self.drift is not None:
                self.drift.observe(scores=scores, fields=fields)
        except Exception:
            # quality telemetry must never take down the training loop
            _LOG.debug("quality feed failed", exc_info=True)

    # -- dense export --------------------------------------------------------

    def export(self) -> Optional[str]:
        """Publish the dense half now (widedeep only).  Never raises —
        a full disk must not stop training; the failure is logged and
        the LATEST pointer keeps naming the previous good artifact."""
        if self.kind != "widedeep" or not self.export_dir:
            return None
        from lightctr_tpu_torch.online.swap import publish_export

        t0 = time.perf_counter()
        try:
            path = publish_export(
                self.export_dir, dict(self.dense), model=self.kind,
                step=self.steps, codec=self.export_codec,
                device=self.device,
            )
        except OSError:
            _LOG.warning("dense export failed; continuing", exc_info=True)
            return None
        self.exports += 1
        if obs_gate.enabled():
            self.registry.inc("online_exports_total")
            self.registry.observe("online_export_seconds",
                                  time.perf_counter() - t0)
        events_mod.emit("online_export", step=self.steps, path=path)
        return path

    # -- the loop ------------------------------------------------------------

    def run(self, stream: Iterable[Dict], max_steps: Optional[int] = None,
            stop=None, prefetch: Optional[int] = None) -> int:
        """Drain ``stream`` (typically infinite — loop/follow mode) until
        it ends, ``stop`` is requested, or ``max_steps`` land.  Returns
        the step count.  ``prefetch=K`` keeps K parsed batches in flight
        behind the step (the step still pulls/pushes PS rows itself —
        prefetch overlaps the parse/pad, the dominant host cost on a
        follow tail)."""
        if prefetch:
            from lightctr_tpu_torch.data import ingest as ingest_mod

            stream = ingest_mod.prefetch_batches(
                stream, depth=prefetch, registry=self.registry)
        try:
            for mb in stream:
                if _stop_requested(stop):
                    break
                if self.step(mb, stop=stop) is None:
                    break
                if max_steps is not None and self.steps >= max_steps:
                    break
        finally:
            if hasattr(stream, "close"):
                stream.close()  # stop the prefetch worker promptly
        return self.steps

    def stats(self) -> Dict:
        return {
            "kind": self.kind,
            "steps": self.steps,
            "examples": self.examples,
            "exports": self.exports,
            "push_failures": self.push_failures,
            "last_loss": self.last_loss,
            "phase_seconds": dict(self.phase_seconds),
        }
