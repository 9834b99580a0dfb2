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
    (its device-telemetry switch) is ``device_telemetry=`` here.
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
    produced, never what is trained.  Without it, ``train_step`` on a card
    stages a host batch itself, through two reused pinned slots and the
    same side stream (:class:`StagingRing`), so the copy overlaps the
    previous step.
  - ``fit`` and ``fit_fullbatch_scan`` take a compiled shard cache (a
    :class:`~lightctr_tpu_torch.data.ingest.ShardCache` or its directory)
    wherever they take an array dict.
  - ``quality_bins`` (or ``LIGHTCTR_QUALITY``) arms the model-quality
    sketch (``obs/quality.py``) on every step variant: it rides the health
    vector and its drain, and is summed over the ranks under a mesh.
  - ``resources`` (or ``LIGHTCTR_RESOURCES``) arms the compile tracker
    over the step's input signatures (``obs/resources.py``);
    ``device_telemetry`` (or ``LIGHTCTR_DEVICE``) arms the program catalog
    (the step's cost and memory recorded from its first armed call), the
    live-buffer census with the trainer state tagged, and the process
    donation watch's binding (``obs/device.py``).  Neither changes what a
    step computes.
  - ``param_shardings`` (a tree of ``core.mesh.Placement``) row-shards the
    leaves under ``embed_sharding`` over the mesh's ``embed`` axis: each
    such leaf is an ``embed.table.ShardedTable`` (this rank's block), the
    models pull its rows through ``embed.table.lookup`` from their owners,
    and its gradient reaches the block only.  The optimizer state takes
    the params' placements and steps on the blocks (every optimizer of the
    registry is elementwise); gradients are averaged over the ``data``
    axis only, since the members of an embed line hold the same rows.
  - ``zero_sharded`` (the JAX step's shard_map, arXiv:2004.13336) runs
    per rank: the flat gradient mean-reduce-scattered over the ``data``
    axis, the optimizer stepped on this rank's 1/n slice with its 1/n of
    the state, the parameters all-gathered.
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
from lightctr_tpu_torch.embed import table as table_mod
from lightctr_tpu_torch.models._common import tree_copy
from lightctr_tpu_torch.obs import device as device_mod
from lightctr_tpu_torch.obs import health as health_mod
from lightctr_tpu_torch.obs import quality as quality_mod
from lightctr_tpu_torch.obs import resources as resources_mod
from lightctr_tpu_torch.obs import stepwatch as stepwatch_mod
from lightctr_tpu_torch.ops import losses as losses_lib
from lightctr_tpu_torch.ops import metrics as metrics_lib
from lightctr_tpu_torch.ops.activations import sigmoid
from lightctr_tpu_torch.optim.updaters import tree_leaves, tree_map
from lightctr_tpu_torch.utils.profiling import annotate, spans_on

_LOG = logging.getLogger(__name__)


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


class _Slot(NamedTuple):
    """One slot of a :class:`StagingRing`: the batch signature its buffers
    were made for, per key a pinned host buffer and a device buffer, and
    its two events."""

    signature: tuple
    host: Dict[str, torch.Tensor]
    dev: Dict[str, torch.Tensor]
    free: Any
    ready: Any


class StagingRing:
    """The two slots through which ``train_step`` puts host batches on a
    card (:meth:`CTRTrainer._put_staged`).  Batches take the slots in
    turn.  A slot's ``free`` event is recorded on the step's stream at the
    next put, when the step that read the slot has been enqueued; before
    the slot is filled again the host waits on it.  That wait keeps the
    host at most one step ahead of the card's running step, and ensures
    that neither of the slot's buffers is still in use.  A slot is made at
    first use and made anew when a batch's keys, shapes, strides or dtypes
    differ from those it holds (the shorter last batch of an epoch).

    ``make_buffers(tensors)`` gives a slot's ``({key: pinned host
    tensor}, {key: device tensor})`` for ``{key: CPU tensor}``, and
    ``make_event()`` an event; the ring itself touches no device."""

    SLOTS = 2

    def __init__(self, make_buffers: Callable, make_event: Callable):
        self._make_buffers = make_buffers
        self._make_event = make_event
        self._slots: list = [None] * self.SLOTS
        self._next = 0
        # the slot the last put filled, its free event not yet recorded
        self._open: Optional[_Slot] = None

    def wait(self, stream) -> None:
        """Record the last filled slot's free event on ``stream``, then
        wait on the host until the slot the next put fills is free."""
        if self._open is not None:
            self._open.free.record(stream)
            self._open = None
        slot = self._slots[self._next]
        if slot is not None:
            slot.free.synchronize()

    def take(self, tensors: Dict[str, torch.Tensor], stream,
             registry) -> _Slot:
        """The next slot, free and fit for ``tensors``, after
        :meth:`wait`.  Counts the batch in ``trainer_input_staged_total``
        and a slot made in ``trainer_input_stage_allocs_total`` of
        ``registry`` (None: telemetry off, nothing counted)."""
        self.wait(stream)
        i = self._next
        self._next = (i + 1) % self.SLOTS
        signature = tuple((k, tuple(t.shape), t.stride(), t.dtype)
                          for k, t in sorted(tensors.items()))
        slot = self._slots[i]
        if slot is None or slot.signature != signature:
            slot = self._slots[i] = _Slot(
                signature, *self._make_buffers(tensors),
                self._make_event(), self._make_event())
            if registry is not None:
                registry.inc("trainer_input_stage_allocs_total")
        if registry is not None:
            registry.inc("trainer_input_staged_total")
        self._open = slot
        return slot


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
        execution: each rank steps on its rows of the global batch (its
        ``data`` index's rows on a mesh of several axes) and the
        gradients are averaged over the ``data`` axis; params are
        replicated unless ``param_shardings`` says otherwise.
    param_shardings: a tree of :class:`~lightctr_tpu_torch.core.mesh.
        Placement` matching ``params`` — e.g. embedding tables under
        ``embed_sharding(mesh)`` (the PS layout), the rest ``replicated``;
        the optimizer state takes the same placements.
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
    resources: arm the compile tracker (``self.resources``, a
        :class:`~lightctr_tpu_torch.obs.resources.CompileTracker` over the
        step's and the scorer's input signatures; ``None`` defers to
        ``LIGHTCTR_RESOURCES``).
    device_telemetry: arm the device plane (``self.device_catalog``,
        ``self.device_census``; ``None`` defers to ``LIGHTCTR_DEVICE``) —
        the JAX trainer's ``device=`` switch.
    device: the torch device of params, state and batches (default
        ``"cuda"``, or the mesh's device).
    zero_sharded: cross-replica weight-update sharding (Xu et al. 2020,
        arXiv:2004.13336): the gradient is reduce-scattered over the
        ``data`` axis, each rank updates its 1/n shard of the flattened
        parameters with its 1/n shard of optimizer state, and the new
        parameters are all-gathered.  Same trajectory as replicated data
        parallelism; the optimizer state per rank drops to 1/n.
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
        device_telemetry: Optional[bool] = None,
        device=None,
    ):
        if fused_adagrad and optimizer is not None:
            raise ValueError("fused_adagrad replaces the optimizer argument")
        if fused_adagrad and compress_bits is not None:
            raise ValueError(
                "fused_adagrad is not supported with compress_bits (the "
                "compressed ring step applies the optimizer transform)")
        if fused_adagrad and param_shardings is not None:
            raise ValueError(
                "fused_adagrad is not supported with param_shardings: the "
                "fused kernel steps whole replicated leaves; use the "
                "optimizer path for sharded params")
        if zero_sharded:
            if mesh is None:
                raise ValueError("zero_sharded requires a mesh (it shards the "
                                 "update over the data axis)")
            if param_shardings is not None or compress_bits is not None \
                    or fused_adagrad:
                raise ValueError(
                    "zero_sharded composes with replicated params and the "
                    "plain optax path only")
        if param_shardings is not None and mesh is None:
            raise ValueError("param_shardings requires a mesh")
        if mesh is not None and not isinstance(mesh, Mesh):
            raise ValueError(f"mesh must be a lightctr_tpu_torch.core.mesh."
                             f"Mesh (make_mesh), got {type(mesh).__name__}")
        #: the mesh as given (of several axes, for a sharded layout)
        self.full_mesh = mesh
        if mesh is not None:
            # the trainer's own collectives run over the data axis
            mesh = mesh.require_axis("data", type(self).__name__)
        if compress_bits is not None and mesh is None:
            raise ValueError("compress_bits requires a mesh (it compresses "
                             "the cross-device gradient exchange)")
        if compress_bits is not None and param_shardings is not None:
            raise ValueError("compress_bits assumes replicated params "
                             "(ring-exchanged data-parallel gradients)")
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
        self.zero_sharded = zero_sharded
        self.param_shardings = param_shardings
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
        if zero_sharded:
            # the flat parameter vector, padded to a multiple of the data
            # axis: each rank updates one 1/n slice of it
            n = mesh.size
            length = collectives.ravel_tree(self.params)[0].numel()
            self._zero_len = length
            self._zero_pad = ((length + n - 1) // n) * n
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
        # resource watch (obs/resources.py): when armed (ctor arg or
        # LIGHTCTR_RESOURCES) a per-trainer CompileTracker polls the
        # distinct input signatures of this trainer's step and scorer
        # every few steps and feeds the recompile-storm detector — a shape
        # leak becomes a /healthz trip
        self.resources: Optional[resources_mod.CompileTracker] = None
        if resources_mod.resolve_armed(resources):
            self.resources = resources_mod.CompileTracker(
                component="trainer", registry=self.telemetry,
                monitor=self.health)
        # device plane (obs/device.py): when armed (ctor arg or
        # LIGHTCTR_DEVICE) a per-trainer ProgramCatalog records the step's
        # cost and memory from its first armed call and a LiveBufferCensus
        # samples the trainer state's storages; the process donation watch
        # binds to this trainer's registry/monitor so verify_donation
        # misses trip the donation_miss detector here
        self.device_catalog: Optional[device_mod.ProgramCatalog] = None
        self.device_census: Optional[device_mod.LiveBufferCensus] = None
        if device_mod.resolve_armed(device_telemetry):
            self.device_catalog = device_mod.ProgramCatalog(
                component="trainer", registry=self.telemetry,
                monitor=self.health, device=self.device)
            self.device_census = device_mod.LiveBufferCensus(
                registry=self.telemetry, monitor=self.health,
                name="trainer")
            self.device_census.register_tag(
                "trainer_state", lambda: (self.params, self.opt_state))
            device_mod.default_donation_watch().bind(
                registry=self.telemetry, monitor=self.health)
        self._steps_seen = 0
        # the card's clock of the catalog's step time, made at first use
        self._step_clock: Optional[device_mod.StepClock] = None
        # the copy stream on a card (the prefetch worker's staging and
        # train_step's staged put), made at first use
        self._stage_stream = None
        self._staging = StagingRing(self._stage_buffers, torch.cuda.Event)
        self.opt_state = self._init_opt_state(self.params)
        self._step = self._build_step()
        self._logits = self.logits_fn
        if self.resources is not None:
            # the JAX trainer tracks its jitted step and scorer; here the
            # same names count the distinct input signatures of each
            self._step = resources_mod.TrackedCallable(self._step)
            self._logits = resources_mod.TrackedCallable(self.logits_fn)
            self.resources.track("trainer_step", self._step)
            self.resources.track("trainer_logits", self._logits)

    def _build_step(self):
        """The training step: the compressed-ring data-parallel step when
        ``compress_bits`` is set, the sharded-weight-update step when
        ``zero_sharded`` is, else the plain one (with a mesh, its
        gradients averaged over the data axis)."""
        if self.compress_bits is not None:
            return self._make_compressed_step()
        if self.zero_sharded:
            return self._make_zero_step()
        return self._make_step()

    def _ring_tree(self, params):
        """The param subtree whose gradients ride the dense (compressed)
        ring — everything, by default; hybrid subclasses keep their table
        leaves off it."""
        return params

    def _own(self, params):
        """The trainer's own copy of ``params`` on its device, under
        ``param_shardings``: steps update in place, so the caller's tree
        (which may seed several trainers) must stay untouched."""
        own = tree_copy(tree_map(
            lambda x: (x.with_local(x.local.to(self.device))
                       if isinstance(x, table_mod.ShardedTable)
                       else torch.as_tensor(x).to(self.device)), params))
        if self.param_shardings is None:
            if table_mod.has_sharded(own):
                raise ValueError("sharded tables need param_shardings")
            return own
        return table_mod.place(own, self.param_shardings, self.device)

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
            with annotate("trainer/forward"):
                # a sharded table's autograd leaf is its block: the forward
                # sees the table, the gradient is the block's
                leaves = leaves_requiring_grad(table_mod.local_view(params))
                out = loss_fn(table_mod.rewrap(leaves, params), batch)
                loss, probs = out if armed else (out, None)
            with annotate("trainer/backward"):
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
        ``[loss, grad_norm]``, so the health feed costs one fetch.  Every
        step variant spans its update (the exchange, the gradient norm,
        the optimizer and the health vector) as ``trainer/optimizer``."""
        grad_fn = self._make_grad_fn()
        tx = self.tx
        mesh = self.mesh

        def exchange(loss, grads):
            if mesh is None:
                return loss, grads
            # the replicas' local means averaged: the global batch's mean
            # loss and gradient (what XLA's psum gives the JAX trainer over
            # a sharded batch)
            return (collectives.pmean(mesh, loss),
                    tree_map(lambda g: collectives.pmean(mesh, g), grads))

        if self.fused_adagrad:
            from lightctr_tpu_torch.optim.fused_adagrad import \
                fused_adagrad_update

            lr, eps = self.cfg.learning_rate, 1e-7

            def step(params, opt_state, batch):
                loss, probs, grads = grad_fn(params, batch)
                with annotate("trainer/optimizer"), torch.no_grad():
                    loss, grads = exchange(loss, grads)
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

        if self.param_shardings is not None:
            view, rewrap = table_mod.local_view, table_mod.rewrap

            def step(params, opt_state, batch):
                loss, probs, grads = grad_fn(params, batch)
                with annotate("trainer/optimizer"), torch.no_grad():
                    loss, grads = exchange(loss, grads)
                    health = self._append_sketch(
                        _health_pack(loss, torch.sqrt(
                            self._sharded_sumsq(grads, params))),
                        probs, batch, mesh)
                    # the optimizer steps on the blocks, elementwise
                    local = view(params)
                    updates, opt_state = tx.update(grads, view(opt_state),
                                                   local)
                    params = rewrap(optim_lib.apply_updates(local, updates),
                                    params)
                    opt_state = table_mod.place_like(opt_state, params)
                return params, opt_state, loss, health

            return step

        def step(params, opt_state, batch):
            loss, probs, grads = grad_fn(params, batch)
            with annotate("trainer/optimizer"), torch.no_grad():
                loss, grads = exchange(loss, grads)
                health = self._append_sketch(
                    _health_pack(loss, global_norm(grads)), probs, batch,
                    mesh)
                updates, opt_state = tx.update(grads, opt_state, params)
                params = optim_lib.apply_updates(params, updates)
            return params, opt_state, loss, health

        return step

    def _sharded_sumsq(self, grads, params) -> torch.Tensor:
        """The square sum of a gradient whose sharded leaves are this
        rank's blocks: theirs summed over the ``embed`` axis, the
        replicated leaves' counted once."""
        rep, own = [], []
        for g, p in zip(tree_leaves(grads), tree_leaves(params)):
            (own if isinstance(p, table_mod.ShardedTable) else rep).append(g)
        own2 = sum_squares(own, device=self.device)
        emb = self.full_mesh.view("embed")
        return (sum_squares(rep, device=self.device)
                + collectives.all_reduce(emb, own2))

    def _make_zero_step(self):
        """Cross-replica sharded weight update (arXiv:2004.13336 / ZeRO-1),
        per rank: the local gradient flattened (``ravel_tree``, JAX's
        ``ravel_pytree`` order) and padded, its mean reduce-scattered over
        the data axis, the optimizer applied to this rank's 1/n slice of
        the flat parameters with its 1/n slice of state, and the new
        slices all-gathered."""
        grad_fn = self._make_grad_fn()
        tx = self.tx
        mesh = self.mesh
        n = mesh.size
        length, padded = self._zero_len, self._zero_pad
        shard = padded // n
        lo = mesh.rank * shard

        def step(params, opt_state, batch):
            loss, probs, grads = grad_fn(params, batch)
            with annotate("trainer/optimizer"), torch.no_grad():
                flat_g, _ = collectives.ravel_tree(grads, device=self.device)
                flat_g = torch.nn.functional.pad(flat_g, (0, padded - length))
                g_shard = collectives.reduce_scatter_mean(mesh, flat_g)
                # ||mean grad|| from the disjoint shards: one sum of the
                # shards' square sums, the same on every rank
                gnorm = torch.sqrt(collectives.all_reduce(
                    mesh, torch.sum(g_shard * g_shard)))
                flat_p, unravel = collectives.ravel_tree(params,
                                                         device=self.device)
                flat_p = torch.nn.functional.pad(flat_p, (0, padded - length))
                p_shard = flat_p[lo:lo + shard]
                updates, opt_state = tx.update(g_shard, opt_state, p_shard)
                p_shard = optim_lib.apply_updates(p_shard, updates)
                full = collectives.all_gather(mesh, p_shard)[:length]
                loss = collectives.pmean(mesh, loss)
                health = self._append_sketch(_health_pack(loss, gnorm),
                                             probs, batch, mesh)
            return unravel(full), opt_state, loss, health

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
            with annotate("trainer/optimizer"), torch.no_grad():
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
        trainer); ``zero_sharded`` keeps this rank's 1/n slice of the
        state of the flat parameters, and refuses an optimizer whose state
        is not elementwise; sharded params give their placements to their
        state."""
        if self.zero_sharded:
            state = self.tx.init(torch.zeros(self._zero_pad,
                                             device=self.device))
            for leaf in tree_leaves(state):
                if tuple(getattr(leaf, "shape", ())) != (self._zero_pad,):
                    raise ValueError(
                        "zero_sharded needs an optimizer whose state is "
                        "elementwise over the parameters (adagrad/rmsprop/"
                        f"sgd-style); got a state leaf of shape "
                        f"{tuple(getattr(leaf, 'shape', ()))}")
            shard = self._zero_pad // self.mesh.size
            lo = self.mesh.rank * shard
            # 1/n of the flattened state lives on each data rank
            return tree_map(lambda x: x[lo:lo + shard].clone(), state)
        if self.param_shardings is not None:
            return table_mod.place_like(
                self.tx.init(table_mod.local_view(params)), params)
        if self.compress_bits is not None:
            return CompressedRingState(
                inner=self.tx.init(params),
                residual=torch.zeros(
                    self._ring_pad if self.error_feedback else 1,
                    dtype=torch.float32, device=self.device))
        return self.tx.init(params)

    def _put(self, batch, non_blocking: bool = False, for_step: bool = False
             ) -> Dict[str, torch.Tensor]:
        """A training batch on this trainer's device: with a mesh, this
        rank's rows of it.  ``for_step`` is :meth:`train_step`'s put, whose
        tensors only that step reads: on a card without a mesh, a batch of
        host memory that is not pinned (:meth:`_put_waits`) is then staged
        through the two-slot ring (:meth:`_put_staged`), and the tensors
        returned are the ring's, overwritten two puts later.  Every other
        put copies on the step's stream."""
        if self.mesh is not None:
            return shard_batch(self.mesh, batch, non_blocking=non_blocking)
        if for_step and self.device.type == "cuda" and self._put_waits(batch):
            return self._put_staged(batch)
        return self._put_whole(batch, non_blocking=non_blocking)

    def _put_whole(self, batch, non_blocking: bool = False
                   ) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(v).to(self.device,
                                         non_blocking=non_blocking)
                for k, v in batch.items()}

    def _copy_stream(self):
        if self._stage_stream is None:
            self._stage_stream = torch.cuda.Stream(device=self.device)
        return self._stage_stream

    def _stage_buffers(self, tensors):
        """A staging slot's buffers for ``tensors``: pinned host memory,
        and device memory of the copy stream's pool, each laid out as
        ``.to()`` would lay out the copy (so a step reads what the
        pageable put gives it, bit for bit)."""
        with torch.cuda.stream(self._copy_stream()):
            dev = {k: torch.empty_like(t, device=self.device)
                   for k, t in tensors.items()}
        host = {k: torch.empty_like(t, pin_memory=True)
                for k, t in tensors.items()}
        return host, dev

    def _put_staged(self, batch) -> Dict[str, torch.Tensor]:
        """:meth:`train_step`'s put of host memory to a card: the host
        copies each array into the next slot of :class:`StagingRing`'s
        pinned buffers (span ``trainer/input_stage``; the caller's arrays
        are free once this returns), the copy stream waits on the slot's
        free event and copies them to the slot's device buffers, and the
        step's stream waits on its ready event before the step's first
        kernel.  The copy thus runs on the copy engine while the card
        finishes the previous step; the only wait left at the put is the
        ring's, for the step before that (:meth:`_wait_stream`)."""
        stream = torch.cuda.current_stream(self.device)
        tensors = {k: torch.as_tensor(v) for k, v in batch.items()}
        host = {k: t for k, t in tensors.items() if t.device.type == "cpu"}
        slot = self._staging.take(
            host, stream, self.telemetry if obs.enabled() else None)
        with annotate("trainer/input_stage"):
            for k, t in host.items():
                slot.host[k].copy_(t)
        copy = self._copy_stream()
        copy.wait_event(slot.free)
        with torch.cuda.stream(copy):
            for k in host:
                slot.dev[k].copy_(slot.host[k], non_blocking=True)
        slot.ready.record(copy)
        stream.wait_event(slot.ready)
        out = {}
        for k, t in tensors.items():
            if k in host:
                t = slot.dev[k]
                # the copy stream's memory, read on the step's stream
                t.record_stream(stream)
            out[k] = t.to(self.device)
        return out

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
        copy = self._copy_stream()
        with torch.cuda.stream(copy):
            pinned = {k: torch.as_tensor(v).pin_memory()
                      for k, v in batch.items()}
            dev = self._put(pinned, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(copy)
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
        skips the transfer.  Otherwise, on a card without a mesh, a batch
        of host memory that is not pinned goes through the staging ring
        (:meth:`_put_staged`): copied into pinned memory by the host and
        to the card on the copy stream, overlapping the previous step;
        the caller may reuse its arrays once this returns.

        With telemetry on, the step's phases are spans (``annotate``: the
        same names on the PyTorch profiler's timeline and in the obs
        tracer), recorded only while a profiler session records or the
        tracer samples: ``trainer/step`` around ``trainer/input``
        (``trainer/input_wait`` inside it before a put that waits, then
        ``trainer/input_stage`` for the staged put's host copy),
        ``trainer/exec`` (the step's own spans: ``trainer/forward``,
        ``trainer/backward``, ``trainer/optimizer``) and
        ``trainer/record``."""
        if not obs.enabled():
            dev_batch = (self._claim(batch) if device_ready
                         else self._put(batch, for_step=True))
            self.params, self.opt_state, loss, _ = self._step(
                self.params, self.opt_state, dev_batch)
            return loss
        t0 = time.perf_counter()
        sw = self.stepwatch
        with annotate("trainer/step", step=self._steps_seen + 1):
            with annotate("trainer/input"):
                if sw is not None:
                    sw.mark("input")
                if device_ready:
                    dev_batch = self._claim(batch)
                else:
                    if spans_on() and self._put_waits(batch):
                        # the put waits anyway: waiting first puts that
                        # wait in a span of its own
                        with annotate("trainer/input_wait"):
                            self._wait_stream()
                    dev_batch = self._put(batch, for_step=True)
            with annotate("trainer/exec"):
                if sw is not None:
                    sw.mark("exec")
                self.params, self.opt_state, loss, health = self._run_step(
                    dev_batch)
            with annotate("trainer/record"):
                self._record_step(time.perf_counter() - t0,
                                  dev_batch if device_ready else batch,
                                  health=health)
        return loss

    def _put_waits(self, batch) -> bool:
        """Whether :meth:`train_step`'s put of ``batch`` copies host memory
        that is not pinned to a card, a put that waits first: without a
        mesh the staged put, for the staging ring's next slot; with one,
        the pageable copy of this rank's rows, for the step's stream."""
        if self.device.type != "cuda":
            return False
        for v in batch.values():
            if isinstance(v, torch.Tensor):
                if v.device.type == "cpu" and not v.is_pinned():
                    return True
            elif isinstance(v, np.ndarray):
                return True
        return False

    def _wait_stream(self) -> None:
        """The wait of a put that :meth:`_put_waits` announces: without a
        mesh, on the free event of the staging ring's next slot (the card
        has finished the step before the previous one,
        :meth:`StagingRing.wait`); with one, for the step's whole
        stream."""
        stream = torch.cuda.current_stream(self.device)
        if self.mesh is None:
            self._staging.wait(stream)
        else:
            stream.synchronize()

    def _run_step(self, dev_batch):
        """``self._step`` on the trainer state; with the device plane
        armed, through the catalog, which records the first call's cost
        and memory (the same call: nothing runs twice)."""
        if self.device_catalog is not None:
            return self.device_catalog.run(
                "trainer_step", self._step,
                (self.params, self.opt_state, dev_batch))
        return self._step(self.params, self.opt_state, dev_batch)

    # -- telemetry ------------------------------------------------------

    def _record_step(self, dt: float, batch, health=None) -> None:
        """Per-step metrics + one JSONL ``step`` event + the health feed.
        ``trainer_step_seconds`` measures the host's launch of the step on
        the card (the caller's loss read is what synchronises); the
        program catalog's step time is the card's (:meth:`_note_catalog`).
        ``batch`` is the caller's host batch (the device batch after a
        prefetch stage put it there), so the health signals read ids
        without a device round trip where they can."""
        reg = self.telemetry
        self._steps_seen += 1
        n = int(len(batch["labels"])) if "labels" in batch else 0
        reg.inc("trainer_steps_total")
        if n:
            reg.inc("trainer_examples_total", n)
        reg.observe("trainer_step_seconds", dt)
        obs.emit_event("step", step=self._steps_seen,
                       duration_s=round(dt, 6), examples=n)
        with annotate("trainer/feed_health"):
            self._feed_health(batch, health)
        if self.resources is not None:
            self.resources.note_step()
        if self.device_catalog is not None:
            # EWMA time fold and the census counter — the analysis was
            # recorded from the step's first armed call
            self._note_catalog(dt)
            self.device_census.maybe_sample()
        # armed profiler captures advance at step boundaries (one global
        # + one flag read when idle)
        device_mod.profile_step()
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
            with annotate("trainer/health_signals"):
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

    def _note_catalog(self, dt: float) -> None:
        """The program catalog's step time: on a card the interval between
        the completion events of consecutive steps (:class:`~lightctr_tpu_
        torch.obs.device.StepClock`, drained without a sync, as the health
        feed drains), so its utilization divides by the card's time; on
        the CPU the host's ``dt``."""
        if self._step_clock is None:
            if self.device.type != "cuda":
                self.device_catalog.note_step(dt, "trainer_step")
                return
            self._step_clock = device_mod.StepClock(self._HEALTH_MAX_LAG)
        for seconds in self._step_clock.mark():
            self.device_catalog.note_step(seconds, "trainer_step")

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

    def arm_stepwatch(self, **kw) -> "stepwatch_mod.StepWatch":
        """Arm (or return) the step stall watchdog against this trainer's
        health monitor — the programmatic twin of ``LIGHTCTR_STALL=1``.
        Keyword arguments forward to
        :class:`~lightctr_tpu_torch.obs.stepwatch.StepWatch`; passing any
        when a watch is already armed (e.g. from the env) replaces it, so
        a caller's explicit deadline/registry always wins."""
        if self.stepwatch is not None and kw:
            self.stepwatch.close()
            self.stepwatch = None
        if self.stepwatch is None:
            self.stepwatch = stepwatch_mod.StepWatch(monitor=self.health,
                                                     **kw)
        return self.stepwatch

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

    def warmup_fullbatch_scan(self, arrays: Dict[str, np.ndarray],
                              epochs: int) -> None:
        """Run one throwaway :meth:`fit_fullbatch_scan` of ``epochs`` steps
        on copies of (params, opt_state), leaving the trainer's state as it
        was — benchmark warm-up (the kernels built and loaded, the caching
        allocator grown, the first launches paid) before a timed run."""
        batch = self._put(self._resolve_arrays(arrays))
        params, state = tree_copy(self.params), tree_copy(self.opt_state)
        for _ in range(epochs):
            params, state, _, _ = self._step(params, state, batch)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def predict_proba(self, arrays: Dict[str, np.ndarray]) -> np.ndarray:
        with torch.no_grad():
            probs = sigmoid(self._logits(self.params,
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
            probs = sigmoid(self._logits(self.params, dev))
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
