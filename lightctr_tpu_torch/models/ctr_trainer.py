"""Shared trainer for the CTR model family, on one device.

The port's counterpart of ``lightctr_tpu/models/ctr_trainer.py``.  The
reference trains with per-model Train()/batchGradCompute/ApplyGrad loops
(e.g. ``train_fm_algo.cpp:35-133``); here one step computes the batched
gradient with autograd and applies the optimizer update on the device.

The reference trains FM full-batch (``__global_minibatch_size =
dataRow_cnt``, train_fm_algo.cpp:38) with one Adagrad step per epoch;
``batch_size=None`` reproduces that, an integer gives minibatch SGD.

Differences from the JAX trainer, by design:

  - ``device=`` is the torch device the params, the optimizer state and
    each batch live on (default ``"cuda"``; it raises without CUDA unless
    the caller asks for ``"cpu"``).  The JAX trainer's ``device: bool``
    arms its device-telemetry plane, which is not ported yet.
  - PyTorch runs eagerly: there is no jit, no donation and no
    ``lax.scan``.  The fused-Adagrad path updates params and state in
    place (what donation buys the JAX trainer); ``fit_fullbatch_scan`` is
    a loop over epochs.
  - Data parallelism is one process per rank (``core/mesh.py``): with
    ``mesh=`` every rank builds the same trainer and is handed the same
    global batch, takes its own rows, and the gradients are averaged over
    the mesh (the plain mean, or the quantile-coded ring with
    ``compress_bits``).  Evaluation and prediction run the whole input on
    each rank (the params are replicated).
  - ``fit(prefetch=)`` and ``fit_stream(prefetch=)`` stage each batch on
    the prefetch worker: on a card, a pinned host copy and an asynchronous
    copy on a side stream, whose event the step waits on before it reads
    the batch (:class:`StagedBatch`).  Prefetch changes when a batch is
    produced, never what is trained.
  - ``fit`` and ``fit_fullbatch_scan`` take a compiled shard cache (a
    :class:`~lightctr_tpu_torch.data.ingest.ShardCache` or its directory)
    wherever they take an array dict.
  - ``quality_bins`` (or ``LIGHTCTR_QUALITY``) arms the model-quality
    sketch (``obs/quality.py``) on every step variant: it rides the health
    vector and its drain, and is summed over the ranks under a mesh.
  - ``param_shardings``, ``zero_sharded`` and the resources plane
    (``resources``) are not ported yet: passing one raises ``ValueError``.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Any, Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from lightctr_tpu_torch import obs
from lightctr_tpu_torch import optim as optim_lib
from lightctr_tpu_torch.core.config import TrainConfig
from lightctr_tpu_torch.core.device import resolve_device
from lightctr_tpu_torch.core.mesh import Mesh, shard_batch
from lightctr_tpu_torch.data import ingest as ingest_mod
from lightctr_tpu_torch.data.batching import minibatches
from lightctr_tpu_torch.dist import collectives
from lightctr_tpu_torch.models._common import tree_copy
from lightctr_tpu_torch.obs import health as health_mod
from lightctr_tpu_torch.obs import quality as quality_mod
from lightctr_tpu_torch.obs import stepwatch as stepwatch_mod
from lightctr_tpu_torch.obs import trace as trace_mod
from lightctr_tpu_torch.ops import losses as losses_lib
from lightctr_tpu_torch.ops import metrics as metrics_lib
from lightctr_tpu_torch.ops.activations import sigmoid
from lightctr_tpu_torch.optim.updaters import tree_leaves, tree_map
from lightctr_tpu_torch.utils.profiling import annotate

_LOG = logging.getLogger(__name__)


def not_yet_ported(owner: str, **args) -> None:
    """Raise ``ValueError`` naming each of ``args`` that was given."""
    given = [k for k, v in args.items() if v is not None and v is not False]
    if given:
        raise ValueError(f"{owner}: {', '.join(given)} not yet ported to "
                         "lightctr_tpu_torch (see ROADMAP.md §A)")


def _health_pack(loss: torch.Tensor, grad_norm: torch.Tensor) -> torch.Tensor:
    """One f32[2] device vector ``[loss, grad_norm]`` — the health feed's
    single-fetch payload (see ``CTRTrainer._feed_health``)."""
    return torch.stack([loss.detach().to(torch.float32),
                        grad_norm.detach().to(torch.float32)])


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum of squares of every tensor in ``grads``
    (``optax.global_norm``); 0 for a tree without leaves."""
    return torch.sqrt(sum_squares(grads))


def sum_squares(tree, device=None) -> torch.Tensor:
    """The sum of squares of every tensor in ``tree`` (a 0-d tensor, 0 for
    a tree without leaves)."""
    leaves = tree_leaves(tree)
    if not leaves:
        return torch.zeros((), device=device)
    return sum(torch.sum(g * g) for g in leaves)


class StagedBatch(NamedTuple):
    """A batch the prefetch worker put on the trainer's device: the
    tensors, and on a card the CUDA event recorded after their copies on
    the worker's side stream (``None`` on the CPU)."""

    batch: Dict[str, torch.Tensor]
    ready: Optional[Any]


class CompressedRingState(NamedTuple):
    """Optimizer state of the wire-compressed data-parallel path: the inner
    optimizer state (replicated) plus this rank's EF-SGD residual carry
    (its row of the JAX package's [n_devices, padded_grad_len] stack)."""

    inner: Any
    residual: torch.Tensor


def leaves_requiring_grad(tree):
    """Fresh autograd leaves over the tensors of ``tree`` (no copies)."""
    return tree_map(lambda x: x.detach().requires_grad_(), tree)


def grads_of(tree):
    """The ``.grad`` of each leaf after ``backward()`` (zeros where the
    loss did not reach a leaf, as ``jax.grad`` gives)."""
    return tree_map(lambda x: x.grad if x.grad is not None
                    else torch.zeros_like(x), tree)


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class CTRTrainer:
    """Binary-CTR trainer over a ``logits(params, batch)`` function, on one
    device.

    Parameters
    ----------
    params: initial parameters, a (nested) dict of tensors or arrays; the
        trainer keeps its own copy on ``device``.
    logits_fn: (params, batch) -> [B] raw scores (pre-sigmoid).
    l2_fn: optional (params, batch) -> scalar penalty, extensive in the
        batch (a sum over the batch's touched features, like
        ``fm.l2_penalty``): it is divided by the batch size alongside the
        summed loss.
    fused_fn: optional (params, batch) -> (logits, l2) from one set of
        gathers (e.g. ``fm.logits_with_l2``); takes precedence over
        (logits_fn-for-training, l2_fn).
    optimizer: a :class:`~lightctr_tpu_torch.optim.GradientTransformation`;
        defaults to Adagrad at ``cfg.learning_rate`` (the reference FM
        family's workhorse, gradientUpdater.h:127-154).
    fused_adagrad: apply Adagrad with the one-pass ``fused_adagrad`` kernel
        per parameter leaf, in place, instead of the optimizer transform.
    mesh: a :class:`~lightctr_tpu_torch.core.mesh.Mesh` for data-parallel
        execution: each rank steps on its rows of the global batch and the
        gradients are averaged over the mesh; params are replicated.
    compress_bits: when set (8 or 16) with a mesh, the gradient exchange
        runs as an explicit ring all-reduce whose every hop is
        quantile-coded to that width (``dist.collectives``).
    compress_range: symmetric quantization range, or ``"dynamic"`` to
        measure it per call (one MAX all-reduce).
    compress_mode: quantile-table shape ("uniform" / "normal" / "log").
        Default: "normal" for ``compress_bits <= 8``, "uniform" above.
    error_feedback: carry each rank's quantization error into its next
        encode (EF-SGD).  Default: on for ``compress_bits <= 8``.
    quality_bins: arm the model-quality sketch with this many probability
        bins (``0`` forces it off; ``None`` defers to ``LIGHTCTR_QUALITY``):
        every step appends an ``f32[4 * bins]`` calibration/AUC/logloss
        sketch of its own forward's probabilities to the health vector, and
        the drain folds it into ``self.quality``, a
        :class:`~lightctr_tpu_torch.obs.quality.QualityTracker`.
    device: the torch device of params, state and batches (default
        ``"cuda"``, or the mesh's device).
    param_shardings, zero_sharded, resources: the JAX trainer's
        sharded-parameter and resources-plane options, not yet ported;
        giving one raises ``ValueError``.
    """

    def __init__(
        self,
        params,
        logits_fn: Callable,
        cfg: TrainConfig,
        l2_fn: Optional[Callable] = None,
        optimizer: Optional[optim_lib.GradientTransformation] = None,
        mesh=None,
        fused_fn: Optional[Callable] = None,
        param_shardings=None,
        compress_bits: Optional[int] = None,
        compress_range=1.0,
        compress_mode: Optional[str] = None,
        error_feedback: Optional[bool] = None,
        fused_adagrad: bool = False,
        zero_sharded: bool = False,
        quality_bins: Optional[int] = None,
        resources: Optional[bool] = None,
        device=None,
    ):
        not_yet_ported(type(self).__name__, param_shardings=param_shardings,
                       zero_sharded=zero_sharded, resources=resources)
        if fused_adagrad and optimizer is not None:
            raise ValueError("fused_adagrad replaces the optimizer argument")
        if fused_adagrad and compress_bits is not None:
            raise ValueError(
                "fused_adagrad is not supported with compress_bits (the "
                "compressed ring step applies the optimizer transform)")
        if mesh is not None and not isinstance(mesh, Mesh):
            raise ValueError(f"mesh must be a lightctr_tpu_torch.core.mesh."
                             f"Mesh (make_mesh), got {type(mesh).__name__}")
        if mesh is not None:
            mesh.require_axis("data", type(self).__name__)
        if compress_bits is not None and mesh is None:
            raise ValueError("compress_bits requires a mesh (it compresses "
                             "the cross-device gradient exchange)")
        self.error_feedback = (
            error_feedback if error_feedback is not None
            else (compress_bits is not None and compress_bits <= 8))
        if error_feedback and compress_bits is None:
            raise ValueError("error_feedback rides the compressed ring; set "
                             "compress_bits")
        if isinstance(compress_range, str) and compress_range != "dynamic":
            raise ValueError(f"compress_range must be a float or 'dynamic', "
                             f"got {compress_range!r}")
        self.compress_mode = (
            compress_mode if compress_mode is not None
            else ("normal" if (compress_bits is not None
                               and compress_bits <= 8) else "uniform"))
        self.mesh = mesh
        self.compress_bits = compress_bits
        self.compress_range = compress_range
        if mesh is not None:
            if device is not None and torch.device(device) != mesh.device:
                raise ValueError(f"device {device!r} is not the mesh's "
                                 f"device {mesh.device}")
            device = mesh.device
        self.device = resolve_device(device if device is not None
                                     else "cuda")
        self.cfg = cfg
        self.logits_fn = logits_fn
        self.l2_fn = l2_fn
        self.fused_fn = fused_fn
        self.fused_adagrad = fused_adagrad
        self.tx = optimizer or optim_lib.adagrad(cfg.learning_rate)
        self.params = self._own(params)
        if compress_bits is not None:
            # the compressed ring flattens the leaves _ring_tree keeps on it
            # (hybrid subclasses exchange their table leaves sparsely) and
            # pads them to a multiple of the ring size
            n = mesh.size
            length = collectives.ravel_tree(
                self._ring_tree(self.params))[0].numel()
            self._ring_pad = ((length + n - 1) // n) * n
        # live telemetry sink; reassign before training to isolate a run
        self.telemetry = obs.default_registry()
        # training-dynamics health: per-step loss + gradient global norm
        # feed the process monitor; reassign ``self.health`` (or None) to
        # isolate/disable
        self.health = health_mod.default_monitor()
        health_mod.ensure_trainer_detectors(self.health)
        # ([loss, grad_norm] device vector, CUDA event or None) of recent
        # steps, oldest first: the health feed drains the ones whose event
        # has completed — reading the in-flight step's values would sync
        # the device every step and stall the launch queue
        self._health_pending: list = []
        # model-quality sketch (obs/quality.py): when armed (ctor arg or
        # LIGHTCTR_QUALITY) every step variant appends a fixed-size
        # f32[4*bins] sketch to the health vector, drained with it; an
        # unarmed trainer keeps the [loss, grad_norm] vector as it was
        self._quality_bins = quality_mod.resolve_bins(quality_bins)
        self.quality: Optional[quality_mod.QualityTracker] = None
        if self._quality_bins is not None:
            self.quality = quality_mod.QualityTracker(
                component="trainer", num_bins=self._quality_bins,
                monitor=self.health, registry=self.telemetry)
        # step stall watchdog (obs/stepwatch.py), armed by LIGHTCTR_STALL=1;
        # rides the per-step drain and marks phases
        self.stepwatch = stepwatch_mod.maybe_from_env(self.health)
        self._steps_seen = 0
        # the prefetch worker's copy stream on a card, made at first use
        self._stage_stream = None
        self.opt_state = self._init_opt_state(self.params)
        self._step = self._build_step()

    def _build_step(self):
        """The training step: the compressed-ring data-parallel step when
        ``compress_bits`` is set, else the plain one (with a mesh, its
        gradients averaged over the mesh)."""
        if self.compress_bits is not None:
            return self._make_compressed_step()
        return self._make_step()

    def _ring_tree(self, params):
        """The param subtree whose gradients ride the dense (compressed)
        ring — everything, by default; hybrid subclasses keep their table
        leaves off it."""
        return params

    def _own(self, params):
        """The trainer's own copy of ``params`` on its device: steps update
        in place, so the caller's tree (which may seed several trainers)
        must stay untouched."""
        return tree_copy(tree_map(
            lambda x: torch.as_tensor(x).to(self.device), params))

    def _make_loss_fn(self, with_probs: bool = False):
        lambda_l2 = self.cfg.lambda_l2
        l2_fn = self.l2_fn
        logits_fn = self.logits_fn
        fused_fn = self.fused_fn

        def loss_fn(params, batch):
            if fused_fn is not None:
                z, l2 = fused_fn(params, batch)
            else:
                z = logits_fn(params, batch)
                l2 = l2_fn(params, batch) if l2_fn is not None else 0.0
            n = z.shape[0]
            loss = losses_lib.logistic_loss(z, batch["labels"],
                                            reduction="sum")
            if lambda_l2 > 0.0:
                loss = loss + lambda_l2 * l2
            if with_probs:
                # for the quality sketch: the predicted probabilities of
                # the same forward (no second scoring pass)
                return loss / n, sigmoid(z.detach())
            return loss / n

        return loss_fn

    def _make_grad_fn(self):
        """``(params, batch) -> (loss, probs, grads)``, ``loss`` detached;
        ``probs`` is the forward's probabilities when the quality sketch is
        armed, else None: one builder, so every step variant gets the same
        arming rule."""
        armed = self._quality_bins is not None
        loss_fn = self._make_loss_fn(with_probs=armed)

        def grad_fn(params, batch):
            leaves = leaves_requiring_grad(params)
            out = loss_fn(leaves, batch)
            loss, probs = out if armed else (out, None)
            loss.backward()
            return loss.detach(), probs, grads_of(leaves)

        return grad_fn

    def _append_sketch(self, health, probs, batch, mesh=None):
        """The health vector with the quality sketch of ``probs`` against
        the batch's labels appended; ``health`` itself when unarmed.  With
        ``mesh`` the rank sketches are summed over the ranks (the JAX
        step's ``psum``), so every rank's tracker covers the global
        batch."""
        qb = self._quality_bins
        if qb is None:
            return health
        sk = quality_mod.quality_sketch(probs, batch["labels"], qb)
        if mesh is not None:
            sk = collectives.all_reduce(mesh, sk)
        return torch.cat([health, sk])

    def _make_step(self):
        """The training step ``(params, opt_state, batch) -> (params,
        opt_state, loss, health)``; ``health`` is one f32[2] device vector
        ``[loss, grad_norm]``, so the health feed costs one fetch."""
        local_grad_fn = self._make_grad_fn()
        tx = self.tx
        mesh = self.mesh

        def grad_fn(params, batch):
            loss, probs, grads = local_grad_fn(params, batch)
            if mesh is not None:
                # the replicas' local means averaged: the global batch's
                # mean loss and gradient (what XLA's psum gives the JAX
                # trainer over a sharded batch)
                with torch.no_grad():
                    loss = collectives.pmean(mesh, loss)
                    grads = tree_map(lambda g: collectives.pmean(mesh, g),
                                     grads)
            return loss, probs, grads

        if self.fused_adagrad:
            from lightctr_tpu_torch.optim.fused_adagrad import \
                fused_adagrad_update

            lr, eps = self.cfg.learning_rate, 1e-7

            def step(params, opt_state, batch):
                loss, probs, grads = grad_fn(params, batch)
                with torch.no_grad():
                    health = self._append_sketch(
                        _health_pack(loss, global_norm(grads)), probs,
                        batch, mesh)
                    # one kernel launch per leaf, in place on w and accum
                    for w, a, g in zip(tree_leaves(params),
                                       tree_leaves(opt_state.accum),
                                       tree_leaves(grads)):
                        fused_adagrad_update(w, a, g, lr, eps)
                return params, opt_state, loss, health

            return step

        def step(params, opt_state, batch):
            loss, probs, grads = grad_fn(params, batch)
            with torch.no_grad():
                health = self._append_sketch(
                    _health_pack(loss, global_norm(grads)), probs, batch,
                    mesh)
                updates, opt_state = tx.update(grads, opt_state, params)
                params = optim_lib.apply_updates(params, updates)
            return params, opt_state, loss, health

        return step

    def _make_compressed_step(self):
        """Data-parallel step whose gradient exchange is an explicit ring
        all-reduce with a quantile codec on every hop (the reference's
        compress-all-wire-traffic policy, paramserver.h:161-163): each rank
        computes its local gradient, the flattened tree rides the coded
        ring (with this rank's EF residual when ``error_feedback``), and
        every rank applies the identical decoded mean."""
        grad_fn = self._make_grad_fn()
        tx = self.tx
        mesh = self.mesh
        n = mesh.size
        bits, crange = self.compress_bits, self.compress_range
        cmode, use_ef = self.compress_mode, self.error_feedback
        padded = self._ring_pad

        def step(params, state, batch):
            loss, probs, grads = grad_fn(params, batch)
            with torch.no_grad():
                flat, unravel = collectives.ravel_tree(grads,
                                                       device=self.device)
                length = flat.shape[0]
                flat = torch.nn.functional.pad(flat, (0, padded - length))
                if use_ef:
                    flat, new_res = collectives._ring_all_reduce_local(
                        flat, mesh, n, average=True, compress_bits=bits,
                        compress_range=crange, residual=state.residual,
                        compress_mode=cmode)
                else:
                    flat = collectives._ring_all_reduce_local(
                        flat, mesh, n, average=True, compress_bits=bits,
                        compress_range=crange, compress_mode=cmode)
                    new_res = state.residual
                grads = unravel(flat[:length])
                # the decoded mean is the same on every rank: so is its norm
                gnorm = global_norm(grads)
                loss = collectives.pmean(mesh, loss)
                updates, inner = tx.update(grads, state.inner, params)
                params = optim_lib.apply_updates(params, updates)
                health = self._append_sketch(_health_pack(loss, gnorm),
                                             probs, batch, mesh)
            return (params, CompressedRingState(inner=inner,
                                                residual=new_res),
                    loss, health)

        return step

    # ------------------------------------------------------------------

    def reset(self, params) -> None:
        """Reset trainer state to fresh (params, opt_state) — repeated
        benchmark runs from one init."""
        self.params = self._own(params)
        self.opt_state = self._init_opt_state(self.params)

    def _init_opt_state(self, params):
        """Optimizer-state factory — subclasses with their own table state
        override this.  The compressed ring adds this rank's EF residual
        (a 1-element placeholder without error feedback, as in the JAX
        trainer)."""
        if self.compress_bits is not None:
            return CompressedRingState(
                inner=self.tx.init(params),
                residual=torch.zeros(
                    self._ring_pad if self.error_feedback else 1,
                    dtype=torch.float32, device=self.device))
        return self.tx.init(params)

    def _put(self, batch, non_blocking: bool = False
             ) -> Dict[str, torch.Tensor]:
        """A training batch on this trainer's device: with a mesh, this
        rank's rows of it."""
        if self.mesh is not None:
            return shard_batch(self.mesh, batch, non_blocking=non_blocking)
        return self._put_whole(batch, non_blocking=non_blocking)

    def _put_whole(self, batch, non_blocking: bool = False
                   ) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(v).to(self.device,
                                         non_blocking=non_blocking)
                for k, v in batch.items()}

    def _prefetch_prepare(self) -> Optional[Callable]:
        """The per-batch transform a prefetch stage runs OFF the step's
        critical path: :meth:`_stage` for this trainer.  Subclasses whose
        step plans against the HOST batch (the sparse trainer's exchange
        planner) return None: prefetch then overlaps only the parse, and
        the step keeps its own ``_put``."""
        return self._stage

    def _stage(self, batch) -> StagedBatch:
        """:meth:`_put` on the prefetch worker's thread.  On a card the
        worker copies the batch into pinned host memory and from there to
        the device on its own stream (a copy from pageable memory would
        block the worker and hide nothing), and records an event after the
        copies; :meth:`_claim` makes the step's stream wait on it."""
        if self.device.type != "cuda":
            return StagedBatch(self._put(batch), None)
        if self._stage_stream is None:
            self._stage_stream = torch.cuda.Stream(device=self.device)
        with torch.cuda.stream(self._stage_stream):
            pinned = {k: torch.as_tensor(v).pin_memory()
                      for k, v in batch.items()}
            dev = self._put(pinned, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(self._stage_stream)
        return StagedBatch(dev, ready)

    def _claim(self, batch) -> Dict[str, torch.Tensor]:
        """A prepared batch for the step: a :class:`StagedBatch`'s tensors
        after the step's stream waits on their copies, each marked as used
        on that stream (the caching allocator then keeps its memory from
        the worker's next batch until the step's kernels are done with
        it); any other dict as it is."""
        if not isinstance(batch, StagedBatch):
            return batch
        if batch.ready is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(batch.ready)
            for t in batch.batch.values():
                t.record_stream(stream)
        return batch.batch

    def train_step(self, batch, *, device_ready: bool = False
                   ) -> torch.Tensor:
        """One optimizer step; returns the 0-d loss tensor on the device
        (reading it synchronises, as reading the JAX device scalar does).
        ``device_ready=True`` says the batch already went through the
        prefetch stage's :meth:`_stage` (or :meth:`_put`), so the step
        skips the transfer."""
        if not obs.enabled():
            dev_batch = (self._claim(batch) if device_ready
                         else self._put(batch))
            self.params, self.opt_state, loss, _ = self._step(
                self.params, self.opt_state, dev_batch)
            return loss
        if trace_mod.enabled():
            # separate path so the default (tracing-off) step pays exactly
            # one extra branch
            return self._train_step_traced(batch, device_ready=device_ready)
        t0 = time.perf_counter()
        sw = self.stepwatch
        if sw is not None:
            sw.mark("input")
        dev_batch = self._claim(batch) if device_ready else self._put(batch)
        if sw is not None:
            sw.mark("exec")
        self.params, self.opt_state, loss, health = self._step(
            self.params, self.opt_state, dev_batch)
        self._record_step(time.perf_counter() - t0,
                          dev_batch if device_ready else batch,
                          health=health)
        return loss

    def _train_step_traced(self, batch, *, device_ready: bool = False
                           ) -> torch.Tensor:
        """Phase-spanned step: ``annotate`` puts the same names on the
        PyTorch profiler's timeline and the wire trace (obs/trace.py)."""
        t0 = time.perf_counter()
        sw = self.stepwatch
        with annotate("trainer/step", step=self._steps_seen + 1):
            with annotate("trainer/input"):
                if sw is not None:
                    sw.mark("input")
                dev_batch = (self._claim(batch) if device_ready
                             else self._put(batch))
            with annotate("trainer/exec"):
                if sw is not None:
                    sw.mark("exec")
                self.params, self.opt_state, loss, health = self._step(
                    self.params, self.opt_state, dev_batch)
        self._record_step(time.perf_counter() - t0,
                          dev_batch if device_ready else batch,
                          health=health)
        return loss

    # -- telemetry ------------------------------------------------------

    def _record_step(self, dt: float, batch, health=None) -> None:
        """Per-step metrics + one JSONL ``step`` event + the health feed.
        ``trainer_step_seconds`` measures the host's launch of the step on
        the card (the caller's loss read is what synchronises).  ``batch``
        is the caller's host batch (the device batch after a prefetch
        stage put it there), so the health signals read ids without a
        device round trip where they can."""
        reg = self.telemetry
        self._steps_seen += 1
        n = int(len(batch["labels"])) if "labels" in batch else 0
        reg.inc("trainer_steps_total")
        if n:
            reg.inc("trainer_examples_total", n)
        reg.observe("trainer_step_seconds", dt)
        obs.emit_event("step", step=self._steps_seen,
                       duration_s=round(dt, 6), examples=n)
        self._feed_health(batch, health)
        if self.stepwatch is not None:
            self.stepwatch.step_completed(dt)

    #: backpressure bound on the health queue — a device more than this
    #: many steps behind gets synced rather than letting a NaN hide in an
    #: ever-growing backlog
    _HEALTH_MAX_LAG = 8

    def _feed_health(self, batch, health) -> None:
        """Per-step ``[loss, grad_norm]`` vectors (and any subclass
        signals) into the health monitor.  A device vector is copied into
        pinned host memory on the step's stream, a CUDA event recorded
        after the copy, and the pair queued; entries are drained
        oldest-first once their event has completed — the feed never syncs
        the in-flight step (a plain ``.cpu()`` would wait for it).  The
        quality tracker drains the same vector (its sketch tail), so an
        armed trainer queues it even with health monitoring off."""
        hm = self.health
        on = hm is not None and health_mod.enabled()
        if on:
            sig = self._health_signals(batch)
            if sig:
                hm.observe(**sig)
        want = (on and hm.wants("loss", "grad_norm")) \
            or self.quality is not None
        if health is None or not want:
            return
        event = None
        if health.is_cuda:
            host = torch.empty(health.shape, dtype=health.dtype,
                               pin_memory=True)
            host.copy_(health, non_blocking=True)
            health = host
            event = torch.cuda.Event()
            event.record()
        pend = self._health_pending
        pend.append((health, event))
        while pend:
            vec, ev = pend[0]
            if ev is not None and not ev.query():
                if len(pend) <= self._HEALTH_MAX_LAG:
                    break
                ev.synchronize()  # backpressure: the device fell behind
            pend.pop(0)
            self._observe_scalars(hm if on else None, vec)

    def _observe_scalars(self, hm, health) -> None:
        vals = health.numpy()  # a host tensor whose copy has completed
        if hm is not None:
            hm.observe(loss=float(vals[0]), grad_norm=float(vals[1]))
        self._feed_quality(vals, 2)

    def _feed_quality(self, vals: np.ndarray, head: int) -> None:
        """Everything past the ``head`` scalars of a drained health vector
        is the quality sketch (when armed): fold it into the tracker, from
        the same copy."""
        if self.quality is not None and vals.shape[0] > head:
            self.quality.update(vals[head:])

    def flush_health(self) -> None:
        """Drain every queued health vector now, waiting for any still in
        flight (end of a run, or a test that wants the verdict)."""
        pend, self._health_pending = self._health_pending, []
        hm = self.health
        on = hm is not None and health_mod.enabled()
        if not on and self.quality is None:
            return
        for vec, ev in pend:
            if ev is not None:
                ev.synchronize()
            self._observe_scalars(hm if on else None, vec)

    def _health_signals(self, batch) -> Dict:
        """Extra health signals subclasses contribute per step (the sparse
        trainer reports per-table touched-uid counts here)."""
        return {}

    def _resolve_arrays(self, arrays):
        """``fit`` / ``fit_fullbatch_scan`` take a compiled shard cache (a
        :class:`~lightctr_tpu_torch.data.ingest.ShardCache` or a cache
        directory) anywhere they take an array dict: re-runs load
        pre-tokenized rows with no parse work."""
        if isinstance(arrays, ingest_mod.ShardCache):
            return ingest_mod.as_arrays(arrays)
        if isinstance(arrays, (str, os.PathLike)):
            return ingest_mod.as_arrays(os.fspath(arrays))
        return arrays

    def _prefetched(self, stream, prefetch: int):
        """``stream`` behind a prefetch stage of ``depth=prefetch``, and
        whether its batches arrive staged on the device."""
        prep = self._prefetch_prepare()
        return ingest_mod.prefetch_batches(
            stream, depth=prefetch, prepare=prep,
            registry=self.telemetry), prep is not None

    def fit_stream(
        self,
        stream,
        max_steps: Optional[int] = None,
        prefetch: Optional[int] = None,
    ) -> list:
        """Drain a stream of padded batch dicts (the streaming reader, …)
        through :meth:`train_step`.  ``prefetch=K`` interposes
        :func:`~lightctr_tpu_torch.data.ingest.prefetch_batches` with
        ``depth=K``: a worker thread keeps K parsed and staged batches in
        flight behind the step (device transfer included whenever
        :meth:`_prefetch_prepare` provides one).  Returns the per-step
        losses."""
        staged = False
        if prefetch:
            stream, staged = self._prefetched(stream, prefetch)
        losses = []
        try:
            for batch in stream:
                losses.append(float(self.train_step(batch,
                                                    device_ready=staged)))
                if max_steps is not None and len(losses) >= max_steps:
                    break
        finally:
            if hasattr(stream, "close"):
                stream.close()  # stop the prefetch worker promptly
        self.flush_health()
        if self.stepwatch is not None:
            self.stepwatch.pause()
        return losses

    def fit(
        self,
        arrays: Dict[str, np.ndarray],
        epochs: Optional[int] = None,
        batch_size: Optional[int] = None,
        eval_arrays: Optional[Dict[str, np.ndarray]] = None,
        eval_every: int = 0,
        verbose: bool = False,
        prefetch: Optional[int] = None,
    ) -> Dict[str, list]:
        """Train ``epochs`` epochs over ``arrays`` (an array dict, or a
        shard cache or its directory): full-batch steps
        (``batch_size=None``) or shuffled minibatches, which
        ``prefetch=K`` stages K ahead on a worker thread (as in
        :meth:`fit_stream`)."""
        arrays = self._resolve_arrays(arrays)
        epochs = epochs if epochs is not None else self.cfg.epochs
        n_rows = len(next(iter(arrays.values())))
        if batch_size is not None and batch_size > n_rows:
            raise ValueError(
                f"batch_size={batch_size} exceeds dataset size {n_rows} "
                "(drop_remainder would yield zero batches); use "
                "batch_size=None for full-batch training")
        history = {"loss": [], "eval": []}
        t0 = time.perf_counter()
        full_batch = self._put(arrays) if batch_size is None else None
        for epoch in range(epochs):
            if batch_size is None:
                self.params, self.opt_state, loss, _ = self._step(
                    self.params, self.opt_state, full_batch)
            else:
                loss = None
                inner = minibatches(arrays, batch_size,
                                    seed=self.cfg.seed + epoch)
                staged = False
                if prefetch:
                    inner, staged = self._prefetched(inner, prefetch)
                for batch in inner:
                    loss = self.train_step(batch, device_ready=staged)
            history["loss"].append(float(loss))
            ev = None
            if (eval_every and eval_arrays is not None
                    and (epoch + 1) % eval_every == 0):
                ev = self.evaluate(eval_arrays)
                history["eval"].append((epoch, ev))
            obs.emit_event("epoch", epoch=epoch, loss=float(loss),
                           **({"eval": ev} if ev is not None else {}))
            if verbose:
                obs.ensure_console_logging()
                _LOG.info("epoch %d: loss=%.5f%s", epoch, float(loss),
                          f" {ev}" if ev is not None else "")
        self.flush_health()  # the last step's pending scalars
        if self.stepwatch is not None:
            # training is done — post-fit idle time is not a wedge; the
            # next train_step re-arms it
            self.stepwatch.pause()
        history["wall_time_s"] = time.perf_counter() - t0
        return history

    def fit_fullbatch_scan(self, arrays: Dict[str, np.ndarray],
                           epochs: int) -> np.ndarray:
        """Run ``epochs`` full-batch steps back to back (the JAX trainer's
        ``lax.scan``; the reference's T-epoch re-train loops,
        main.cpp:227-229) and return the loss trajectory, read once at the
        end.  ``arrays`` may be a shard cache or its directory."""
        batch = self._put(self._resolve_arrays(arrays))
        losses = []
        for _ in range(epochs):
            self.params, self.opt_state, loss, _ = self._step(
                self.params, self.opt_state, batch)
            losses.append(loss)
        return torch.stack(losses).cpu().numpy()

    def predict_proba(self, arrays: Dict[str, np.ndarray]) -> np.ndarray:
        with torch.no_grad():
            probs = sigmoid(self.logits_fn(self.params,
                                           self._put_whole(arrays)))
        return probs.cpu().numpy()

    def evaluate(self, arrays: Dict[str, np.ndarray],
                 batch_size: Optional[int] = None) -> Dict[str, float]:
        """Logloss / accuracy / AUC report, matching FM_Predict
        (fm_predict.cpp:56-77).  With ``batch_size``, evaluation streams in
        fixed-size chunks with running sums + streaming AUC histograms."""
        with annotate("trainer/eval", examples=int(len(arrays["labels"]))):
            with torch.no_grad():
                return self._evaluate(arrays, batch_size)

    def _evaluate(self, arrays, batch_size=None) -> Dict[str, float]:
        labels_all = arrays["labels"]
        n = len(labels_all)
        if batch_size is None or batch_size >= n:
            probs = torch.as_tensor(self.predict_proba(arrays))
            labels = torch.as_tensor(_host(labels_all))
            return {
                "logloss": float(metrics_lib.logloss(probs, labels)),
                "accuracy": float(metrics_lib.accuracy(
                    (probs > 0.5).to(torch.int32), labels.to(torch.int32))),
                "auc": float(metrics_lib.auc_histogram(
                    probs, labels.to(torch.int32))),
            }
        auc = metrics_lib.StreamingAUC()
        loss_sum = 0.0
        correct = 0.0
        seen = 0
        for s in range(0, n, batch_size):  # includes the tail remainder
            chunk = {k: v[s: s + batch_size] for k, v in arrays.items()}
            m = len(chunk["labels"])
            # stay on the device: logits -> sigmoid -> metrics
            dev = self._put_whole(chunk)
            probs = sigmoid(self.logits_fn(self.params, dev))
            labels = dev["labels"]
            loss_sum += float(metrics_lib.logloss(probs, labels)) * m
            correct += float(torch.sum(
                (probs > 0.5).to(torch.int32) == labels.to(torch.int32)))
            auc.update(probs, labels.to(torch.int32))
            seen += m
        return {
            "logloss": loss_sum / seen,
            "accuracy": correct / seen,
            "auc": auc.result(),
        }
