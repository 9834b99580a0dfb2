"""Device & program observability plane: per-program cost/memory
analytics, live-buffer census, donation (in-place) verification, and
on-demand profiler capture — the port's counterpart of
``lightctr_tpu/obs/device.py``.

The resources plane instruments the *host* (signature ladders, queues,
RSS); this module instruments the *device* side — what a program costs,
where device memory goes, and whether the in-place promises held.  Four
families:

- **program analytics** — :class:`ProgramCatalog` records, from the first
  call of each registered program made while the plane is armed (the
  trainer step, the serve scorers, the online gradient step), the FLOPs
  and bytes of its library ops (a dispatch mode over every aten op: the
  formulas of ``torch.utils.flop_counter`` for the products, one
  operation an element for pointwise ops, each op's inputs read once and
  outputs written once) plus each hand-written kernel's bytes and
  operations as ``ops/sparse_kernels.kernel_cost`` counts them from its
  inputs, and the call's memory: arguments, outputs, the outputs that
  alias an argument (in-place updates), and on a card the allocator's
  peak above what was allocated before the call.  There is nothing to
  lower in eager PyTorch, and replaying a step would apply its in-place
  update twice, so the analysis is of that one real call.  From observed
  step times it derives arithmetic intensity and an achieved-vs-peak
  utilization gauge against :data:`PEAK_SPECS` (H100 rows only); a device
  without a spec (the CPU) reports utilization as unavailable, and a
  program never called armed reports ``"unavailable"``.
- **live-buffer census** — :class:`LiveBufferCensus` buckets the tensors
  of registered source tags by (tag, shape, dtype), counting a storage
  shared by several views once; the rest of the caching allocator's
  bytes is ``untagged`` (autograd's saved tensors and tensors held in C++
  are invisible to a Python walk, hence the allocator total).  On the CPU
  there is no allocator total and ``untagged`` is reported unavailable.
  Per-tag budgets feed the ``hbm_pressure`` detector.
- **donation verification** — :func:`verify_donation` wraps a callable
  that promises to write some of its inputs in place (the port's
  counterpart of buffer donation) and checks, by storage pointer before
  and after, that each such input is the storage written (it comes back
  among the outputs at the same pointer): a copy is a ``donation_miss``.
- **profiler capture** — :class:`ProfileTrigger` arms ``torch.profiler``
  for the next N steps via ``POST /profilez`` (409 when the profiler is
  absent or another capture is active, 429 inside the rate window,
  bounded capture dir) and can auto-arm a one-shot capture when
  ``stall`` / ``memory_pressure`` / ``hbm_pressure`` trips
  (:func:`install_auto_capture`, ``LIGHTCTR_PROFILE_AUTO=1``).

Catalog, census, donation watch and trigger are ``/devicez`` providers
and ``device:*`` flight registries; :func:`device_rollup` extracts the
cluster view.  ``LIGHTCTR_DEVICE=1`` arms the per-trainer catalog +
census (:func:`resolve_armed`; the trainers' switch is
``device_telemetry=``, since their ``device=`` is the torch device).
Everything is gated on the obs switch.
"""

from __future__ import annotations

import logging
import os
import shutil
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from lightctr_tpu_torch.obs import events as events_mod
from lightctr_tpu_torch.obs import exporter as exporter_mod
from lightctr_tpu_torch.obs import flight as flight_mod
from lightctr_tpu_torch.obs import gate
from lightctr_tpu_torch.obs import health as health_mod
from lightctr_tpu_torch.obs import resources as resources_mod
from lightctr_tpu_torch.obs.registry import MetricsRegistry, default_registry, labeled

_LOG = logging.getLogger("lightctr.obs.device")

# Every series this plane emits (both-directions AST lint in
# tests/test_torch_device.py, the JAX package's names).  All device_*
# emissions live in THIS module — wiring call sites go through the classes
# below, so the lint covers the whole family.
DEVICE_SERIES = (
    "device_program_flops",            # gauge, {program} — recorded FLOPs
    "device_program_bytes_accessed",   # gauge, {program} — bytes touched
    "device_program_intensity",        # gauge, {program} — flops/byte
    "device_program_utilization",      # gauge, {program} — achieved/peak
    "device_program_memory_bytes",     # gauge, {program, kind} — arg/out/temp
    "device_program_time_seconds",     # histogram, {program} — observed step
    "device_live_buffer_bytes",        # gauge, {tag} — census bytes
    "device_live_buffer_count",        # gauge, {tag} — census tensor count
    "device_live_budget_bytes",        # gauge, {tag} — census budget
    "device_donation_checks_total",    # counter, {program}
    "device_donation_miss_total",      # counter, {program} — failed in-place
    "device_profile_captures_total",   # counter — landed profiler captures
    "device_profile_refused_total",    # counter, {reason} — arm refusals
)

#: (device-name substring, (peak FLOP/s, peak HBM bytes/s)) per card,
#: matched in order against ``torch.cuda.get_device_name().lower()``
#: (e.g. "NVIDIA H100 80GB HBM3" is the SXM5 board).  The FLOP/s is the
#: FP32 rate WITHOUT tensor cores: the port's products run in float32
#: with TF32 off, so the tensor-core rates (BF16 989 TFLOP/s dense, TF32
#: 494.7) are not what its programs can reach.  Source: NVIDIA H100 Tensor
#: Core GPU datasheet (FP32 67 / 51 / 60 TFLOP/s, HBM 3.35 / 2.0 /
#: 3.9 TB/s for SXM5 / PCIe / NVL).  Cards with no entry (the CPU, other
#: GPUs) report utilization as unavailable rather than against a made-up
#: peak.
PEAK_SPECS: Tuple[Tuple[str, Tuple[float, float]], ...] = (
    ("h100 nvl", (60e12, 3.9e12)),
    ("h100 pcie", (51e12, 2.0e12)),
    ("h100 80gb hbm3", (67e12, 3.35e12)),
    ("h100 sxm", (67e12, 3.35e12)),
)

#: what the FLOP/s of :data:`PEAK_SPECS` counts
PEAK_PRECISION = "fp32 (no tensor cores)"


def peak_spec(device_kind: Optional[str]) -> Optional[Tuple[float, float]]:
    """The (peak FLOP/s, peak HBM B/s) pair for a device name, or None
    when the name has no published spec here (the honest CPU path)."""
    if not device_kind:
        return None
    kind = str(device_kind).lower()
    for key, spec in PEAK_SPECS:
        if key in kind:
            return spec
    return None


def resolve_armed(explicit: Optional[bool] = None) -> bool:
    """Whether the per-trainer device plane is armed: an explicit ctor
    argument wins; otherwise ``LIGHTCTR_DEVICE`` (``1``/``true`` arms,
    unset/falsy leaves it off — zero per-step cost when dark)."""
    if explicit is not None:
        return bool(explicit)
    v = os.environ.get("LIGHTCTR_DEVICE", "").strip().lower()
    return v not in ("", "0", "false", "off", "no")


# -- detectors ---------------------------------------------------------------


class HbmPressureDetector(resources_mod.MemoryPressureDetector):
    """Census bytes past their per-tag budget fraction — literally the
    resources plane's :class:`MemoryPressureDetector` judging the
    ``hbm_pressure`` signal the census feeds, so the budget semantics
    (tags with no budget tracked but never judged, worst fraction wins)
    stay identical across host and device memory."""

    name = "hbm_pressure"
    signals = ("hbm_pressure",)

    def check(self, signals):
        return super().check({"memory_pressure": signals["hbm_pressure"]})


class DonationMissDetector(health_mod.Detector):
    """An input promised to be written in place that was copied instead:
    the call still computed the right answer, but memory doubled on
    exactly the buffers (embedding tables, optimizer state) the in-place
    update was meant to keep single.  A miss is structural, so one miss
    trips immediately; the latest verdict per program is tracked, so a
    replacement that writes in place again recovers."""

    name = "donation_miss"
    signals = ("donation",)
    trip_after = 1
    recover_after = 1

    def __init__(self):
        # program -> consecutive misses since it last aliased
        self._missing: Dict[str, int] = {}

    def check(self, signals):
        d = signals["donation"]
        prog = str(d.get("program", "?"))
        if d.get("miss"):
            self._missing[prog] = self._missing.get(prog, 0) + 1
        else:
            self._missing.pop(prog, None)
        if self._missing:
            worst = max(self._missing.items(), key=lambda kv: kv[1])
            return health_mod.DEGRADED, {
                "programs": sorted(self._missing),
                "worst_program": worst[0],
                "misses": int(sum(self._missing.values())),
            }
        return health_mod.OK, {"programs": []}


DEVICE_DETECTORS = (HbmPressureDetector, DonationMissDetector)
health_mod.KNOWN_DETECTORS.update(
    {cls.name: cls for cls in DEVICE_DETECTORS})


def ensure_device_detectors(monitor: health_mod.HealthMonitor,
                            **overrides) -> None:
    """Install the device detectors on ``monitor`` (idempotent)."""
    for cls in DEVICE_DETECTORS:
        monitor.ensure_detector(cls(**overrides.get(cls.name, {})))


# -- /devicez provider registry ----------------------------------------------

_providers: Dict[str, Callable[[], Dict]] = {}
_providers_lock = threading.Lock()


def device_payload() -> Dict:
    """The ``/devicez`` JSON body: every registered provider's payload."""
    with _providers_lock:
        items = list(_providers.items())
    out: Dict = {}
    for name, fn in items:
        try:
            out[name] = fn()
        except Exception as e:  # one broken provider must not 500 the route
            out[name] = {"error": str(e)}
    return {"device": out}


def register_provider(name: str, fn: Callable[[], Dict]) -> None:
    """Register a ``/devicez`` section provider and (lazily) the route."""
    with _providers_lock:
        _providers[name] = fn
    exporter_mod.register_json_route("/devicez", device_payload)


def unregister_provider(name: str) -> None:
    with _providers_lock:
        _providers.pop(name, None)


# -- program analytics -------------------------------------------------------


def tensor_leaves(tree) -> List[torch.Tensor]:
    """The tensors of a (nested) dict / list / tuple / NamedTuple; a
    sharded table's block (``embed.table.ShardedTable``)."""
    from lightctr_tpu_torch.embed.table import ShardedTable

    out: List[torch.Tensor] = []

    def walk(x):
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, ShardedTable):
            out.append(x.local)
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)

    walk(tree)
    return out


def _storage_key(t: torch.Tensor):
    return (t.device.type, t.device.index,
            t.untyped_storage().data_ptr())


def storage_bytes(tree) -> Tuple[int, set]:
    """(bytes, storage keys) of the distinct storages under ``tree``: a
    storage shared by several views counts once."""
    seen: Dict = {}
    for t in tensor_leaves(tree):
        if t.numel() == 0:
            continue
        seen.setdefault(_storage_key(t), t.untyped_storage().nbytes())
    return int(sum(seen.values())), set(seen)


def _spec_tree(tree):
    """Shapes and dtypes of the tensor leaves (what ``offer`` records —
    never the tensors: a catalog must not pin training state live)."""
    return [(tuple(t.shape), str(t.dtype)) for t in tensor_leaves(tree)]


class _CostMode(TorchDispatchMode):
    """Counts the FLOPs and bytes of every aten op dispatched under it:
    ``torch.utils.flop_counter``'s formulas for the products, one
    operation an output element for pointwise ops; each op's tensor
    inputs read once and outputs written once (views and allocations
    move nothing).  Ops run inside a hand-written kernel's dispatch (a
    plain version on the CPU) are skipped: the kernel reports its own
    cost."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        from lightctr_tpu_torch.ops import sparse_kernels
        self._flop_registry = flop_registry
        self._sk = sparse_kernels
        self.flops = 0.0
        self.nbytes = 0
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._sk.in_kernel():
            return out
        try:
            self._count(func, args, kwargs, out)
        except Exception:
            _LOG.debug("cost count failed for %s", func, exc_info=True)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        self.ops += 1
        packet = func.overloadpacket
        fn = self._flop_registry.get(packet)
        if fn is not None:
            self.flops += float(fn(*args, **kwargs, out_val=out))
        elif torch.Tag.pointwise in func.tags:
            self.flops += float(sum(t.numel() for t in tensor_leaves(out)))
        name = packet.__name__
        if func.is_view or name.startswith("empty"):
            return
        ins = tensor_leaves((args, kwargs))
        outs = tensor_leaves(out)
        self.nbytes += sum(t.numel() * t.element_size() for t in ins)
        self.nbytes += sum(t.numel() * t.element_size() for t in outs)


def _record_call(fn, args, kwargs, device: Optional[torch.device]):
    """Run ``fn(*args, **kwargs)`` once under the cost counters; returns
    (its result, the analysis dict)."""
    from lightctr_tpu_torch.ops import sparse_kernels

    kernels: Dict[str, List[float]] = {}
    lock = threading.Lock()

    def sink(name, nbytes, flops):
        with lock:
            k = kernels.setdefault(name, [0, 0.0, 0.0])
            k[0] += 1
            k[1] += nbytes
            k[2] += flops

    cuda = (device is not None and device.type == "cuda"
            and torch.cuda.is_available())
    arg_bytes, arg_keys = storage_bytes((args, kwargs))
    if cuda:
        torch.cuda.synchronize(device)
        base = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    mode = _CostMode()
    with sparse_kernels.record_costs(sink), mode:
        out = fn(*args, **kwargs)
    memory: Dict[str, int] = {"argument": arg_bytes}
    if cuda:
        torch.cuda.synchronize(device)
        memory["temp"] = max(0, torch.cuda.max_memory_allocated(device)
                             - base)
    out_bytes, out_keys = storage_bytes(out)
    alias, _ = storage_bytes([t for t in tensor_leaves(out)
                              if t.numel() and _storage_key(t) in arg_keys])
    memory["output"] = out_bytes
    memory["alias"] = alias
    if "temp" in memory:
        memory["peak_estimate"] = max(
            0, memory["argument"] + memory["output"] + memory["temp"]
            - memory["alias"])
    k_bytes = sum(v[1] for v in kernels.values())
    k_flops = sum(v[2] for v in kernels.values())
    flops = mode.flops + k_flops
    nbytes = float(mode.nbytes + k_bytes)
    analysis: Dict = {
        "available": True,
        "flops": flops,
        "bytes_accessed": nbytes,
        "library": {"flops": mode.flops, "bytes": mode.nbytes,
                    "ops": mode.ops},
        "kernels": {name: {"calls": int(v[0]), "bytes": int(v[1]),
                           "flops": v[2]}
                    for name, v in sorted(kernels.items())},
        "memory": memory,
    }
    if flops and nbytes:
        analysis["intensity"] = flops / nbytes
    return out, analysis


def _backend_kind(device=None) -> Tuple[Optional[str], Optional[str]]:
    try:
        dev = (torch.device(device) if device is not None else
               torch.device("cuda" if torch.cuda.is_available() else "cpu"))
        if dev.type == "cuda":
            return "cuda", torch.cuda.get_device_name(dev)
        return dev.type, None
    except Exception:
        return None, None


class StepClock:
    """A card's time per step, read without a sync: :meth:`mark` records a
    CUDA event on the current stream after a step, and returns the
    intervals (seconds) between consecutive events that have completed by
    then, oldest first.  Events still in flight wait for a later mark;
    more than ``max_lag`` of them and the oldest is waited for
    (backpressure, as the trainers' health feed drains).  ``event`` makes
    the events (a timing ``torch.cuda.Event`` by default)."""

    def __init__(self, max_lag: int = 8, event: Optional[Callable] = None):
        self.max_lag = int(max_lag)
        self._event = event or (
            lambda: torch.cuda.Event(enable_timing=True))
        self._pending: List = []
        self._last = None

    def mark(self) -> List[float]:
        ev = self._event()
        ev.record()
        pend = self._pending
        pend.append(ev)
        out: List[float] = []
        while pend:
            head = pend[0]
            if not head.query():
                if len(pend) <= self.max_lag:
                    break
                head.synchronize()
            pend.pop(0)
            if self._last is not None:
                out.append(1e-3 * self._last.elapsed_time(head))
            self._last = head
        return out


class ProgramCatalog:
    """Cost/memory analytics for registered programs.

    ``run(name, fn, args)`` calls ``fn(*args)``; the first armed call per
    name runs under the cost counters and records the analysis (a one-time
    cost: every later call is a dict lookup and the call itself).
    ``offer(name, fn, args)`` registers a program's arg specs without
    calling it (the JAX package's registration): a program never run
    armed analyzes as ``"unavailable"``.  ``note_step(dt, program)`` folds
    an observed step time into an EWMA so utilization (achieved FLOP/s vs
    :func:`peak_spec`) stays live (the trainers feed the card's time, from
    a :class:`StepClock`, and the host's on the CPU); on a device with no
    peak spec (the CPU) utilization is ``None`` — unavailable, not fake.

    Registers as a ``device:<component>`` flight registry and a
    ``/devicez`` provider; ``close()`` unregisters both.
    """

    def __init__(self, component: str = "process",
                 registry: Optional[MetricsRegistry] = None,
                 monitor: Optional[health_mod.HealthMonitor] = None,
                 poll_every: int = 32, max_programs: int = 64,
                 peak_flops: Optional[float] = None,
                 peak_hbm_bps: Optional[float] = None,
                 detector_overrides: Optional[Dict] = None,
                 device=None):
        self.component = str(component)
        self.registry = registry if registry is not None else default_registry()
        self.poll_every = int(poll_every)
        self.max_programs = int(max_programs)
        self.monitor = monitor
        if monitor is not None:
            ensure_device_detectors(monitor, **dict(detector_overrides or {}))
        self.device = None if device is None else torch.device(device)
        self.backend, self.device_kind = _backend_kind(self.device)
        if peak_flops is not None or peak_hbm_bps is not None:
            self.peak: Optional[Tuple[float, float]] = (
                float(peak_flops or 0.0), float(peak_hbm_bps or 0.0))
        else:
            self.peak = peak_spec(self.device_kind)
        self._lock = threading.Lock()
        self._programs: Dict[str, Dict] = {}
        self._steps = 0
        flight_mod.register_registry(f"device:{self.component}", self)
        register_provider(self.component, self.payload)
        # a catalog implies someone wants the device plane: make sure the
        # POST /profilez trigger exists on this process's ops server
        profile_trigger()

    def close(self) -> None:
        flight_mod.unregister_registry(f"device:{self.component}")
        unregister_provider(self.component)

    # -- registration --------------------------------------------------------

    @staticmethod
    def _new_record(fn) -> Dict:
        return {"fn": fn, "specs": None, "analysis": None, "error": None,
                "steps": 0, "ewma_s": None}

    def offer(self, name: str, fn, args=(), kwargs=None) -> None:
        """Record a program and its arg specs without calling it.  First
        offer per name wins; a non-callable registers as unanalyzable."""
        name = str(name)
        if name in self._programs:  # lock-free fast path (benign race)
            return
        with self._lock:
            if name in self._programs:
                return
            if len(self._programs) >= self.max_programs:
                return
            rec = self._new_record(fn)
            if not callable(fn):
                rec["error"] = "not callable"
            else:
                rec["specs"] = _spec_tree((args, kwargs or {}))
            self._programs[name] = rec

    def run(self, name: str, fn, args=(), kwargs=None):
        """``fn(*args, **kwargs)``; the first call per name made here is
        recorded (its analysis read from that very call).  A program past
        ``max_programs`` runs unrecorded."""
        kwargs = kwargs or {}
        rec = self._programs.get(str(name))
        if rec is not None and (rec["analysis"] is not None
                                or rec["error"] is not None):
            return fn(*args, **kwargs)
        name = str(name)
        with self._lock:
            rec = self._programs.get(name)
            if rec is None:
                if len(self._programs) >= self.max_programs:
                    rec = None
                else:
                    rec = self._programs[name] = self._new_record(fn)
            busy = rec is not None and rec.get("recording")
            if rec is not None and not busy:
                rec["recording"] = True
        if rec is None or busy:
            return fn(*args, **kwargs)
        try:
            rec["specs"] = _spec_tree((args, kwargs))
            out, analysis = _record_call(fn, args, kwargs, self.device)
        except RuntimeError as e:
            if "cost recorder is already set" not in str(e):
                raise
            # another program is being recorded on another thread: this
            # call runs unrecorded, a later one records
            with self._lock:
                rec["recording"] = False
            return fn(*args, **kwargs)
        with self._lock:
            rec["analysis"], rec["recording"] = analysis, False
        self._publish(name)
        return out

    # -- feed ----------------------------------------------------------------

    def note_step(self, seconds: float, program: str) -> None:
        """Per-step hook: fold one observed step time for ``program``
        into its EWMA + histogram; refresh the utilization gauge every
        ``poll_every`` steps from the recorded analysis (plain
        arithmetic)."""
        program = str(program)
        dt = float(seconds)
        due = False
        with self._lock:
            rec = self._programs.get(program)
            if rec is not None:
                rec["steps"] += 1
                prev = rec["ewma_s"]
                rec["ewma_s"] = dt if prev is None else 0.9 * prev + 0.1 * dt
            self._steps += 1
            if (self.poll_every > 0 and rec is not None
                    and rec["analysis"] is not None
                    and rec["steps"] % self.poll_every == 0):
                due = True
        if not gate.enabled():
            return
        self.registry.observe(
            labeled("device_program_time_seconds", program=program), dt)
        if due:
            self._publish(program)

    # -- analysis ------------------------------------------------------------

    def analyze(self, name: Optional[str] = None,
                force: bool = False) -> Dict[str, Dict]:
        """The recorded analyses; a program never called armed (or not
        callable) is ``{"available": False, "unavailable": why}``.
        ``force`` is accepted for the JAX signature: an eager program
        cannot be re-analyzed without running it again."""
        with self._lock:
            names = [name] if name is not None else list(self._programs)
            out: Dict[str, Dict] = {}
            for n in names:
                rec = self._programs.get(n)
                if rec is None:
                    continue
                if rec["analysis"] is not None:
                    out[n] = rec["analysis"]
                else:
                    out[n] = {"available": False,
                              "unavailable": rec["error"]
                              or "never called while armed"}
        return out

    def _utilization(self, rec: Dict) -> Dict[str, Optional[float]]:
        """Achieved FLOP/s / bandwidth from the EWMA step time, and
        compute utilization against the peak spec — all None when the
        analysis, timing, or peak is missing (unavailable, never fake)."""
        analysis = rec.get("analysis") or {}
        ewma = rec.get("ewma_s")
        out: Dict[str, Optional[float]] = {
            "achieved_flops_per_s": None, "achieved_bytes_per_s": None,
            "utilization": None, "bandwidth_utilization": None}
        if not ewma or ewma <= 0.0 or not analysis.get("available"):
            return out
        flops, ba = analysis.get("flops"), analysis.get("bytes_accessed")
        if flops:
            out["achieved_flops_per_s"] = flops / ewma
        if ba:
            out["achieved_bytes_per_s"] = ba / ewma
        if self.peak is not None:
            pf, pb = self.peak
            if flops and pf > 0.0:
                out["utilization"] = (flops / ewma) / pf
            if ba and pb > 0.0:
                out["bandwidth_utilization"] = (ba / ewma) / pb
        return out

    def _publish(self, name: str) -> None:
        """Gauge refresh for one analyzed program (only values that
        exist — an unavailable metric publishes nothing)."""
        if not gate.enabled():
            return
        with self._lock:
            rec = self._programs.get(name)
            if rec is None or rec["analysis"] is None:
                return
            analysis = dict(rec["analysis"])
            util = self._utilization(rec)
        reg = self.registry
        if analysis.get("flops") is not None:
            reg.gauge_set(labeled("device_program_flops", program=name),
                          analysis["flops"])
        if analysis.get("bytes_accessed") is not None:
            reg.gauge_set(
                labeled("device_program_bytes_accessed", program=name),
                analysis["bytes_accessed"])
        if analysis.get("intensity") is not None:
            reg.gauge_set(labeled("device_program_intensity", program=name),
                          analysis["intensity"])
        if util["utilization"] is not None:
            reg.gauge_set(
                labeled("device_program_utilization", program=name),
                util["utilization"])
        for kind, v in (analysis.get("memory") or {}).items():
            reg.gauge_set(
                labeled("device_program_memory_bytes", program=name,
                        kind=kind), v)

    # -- reads (flight duck-type + /devicez section) -------------------------

    def snapshot(self, reset: bool = False) -> Dict:
        with self._lock:
            programs = {
                name: {
                    "analyzed": rec["analysis"] is not None,
                    "error": rec["error"],
                    "steps": rec["steps"],
                    "ewma_seconds": (None if rec["ewma_s"] is None
                                     else round(rec["ewma_s"], 6)),
                    "analysis": rec["analysis"],
                    **self._utilization(rec),
                }
                for name, rec in sorted(self._programs.items())
            }
            return {
                "device": True,
                "component": self.component,
                "backend": self.backend,
                "device_kind": self.device_kind,
                "peak": (None if self.peak is None
                         else {"flops_per_s": self.peak[0],
                               "hbm_bytes_per_s": self.peak[1],
                               "precision": PEAK_PRECISION}),
                "steps": self._steps,
                "programs": programs,
            }

    def payload(self) -> Dict:
        """The ``/devicez`` section, refreshing the gauges of every
        analyzed program."""
        with self._lock:
            names = [n for n, r in self._programs.items()
                     if r["analysis"] is not None]
        for n in names:
            self._publish(n)
        return self.snapshot()


_default_lock = threading.Lock()
_default_catalog: Optional[ProgramCatalog] = None


def default_catalog() -> ProgramCatalog:
    """The process-wide program catalog (call-site sugar records into
    it; a trainer-owned catalog keeps its own set).  Lazy."""
    global _default_catalog
    with _default_lock:
        if _default_catalog is None:
            _default_catalog = ProgramCatalog(component="process")
        return _default_catalog


def reset_default_catalog() -> None:
    """Drop the process catalog (tests)."""
    global _default_catalog
    with _default_lock:
        if _default_catalog is not None:
            _default_catalog.close()
            _default_catalog = None


def offer(name: str, fn, args=(), kwargs=None) -> None:
    """Call-site sugar: register a program with the process catalog when
    the device plane is armed (``LIGHTCTR_DEVICE``); a cheap no-op
    otherwise."""
    c = _default_catalog
    if c is None:
        if not resolve_armed(None):
            return
        c = default_catalog()
    c.offer(name, fn, args, kwargs)


def call(name: str, fn, args=(), kwargs=None):
    """Call-site sugar: ``fn(*args, **kwargs)``, recorded by the process
    catalog on its first call while the device plane is armed
    (``LIGHTCTR_DEVICE``, or a process catalog already made) — the port's
    ``offer`` at the serve and online call paths; the plain call
    otherwise."""
    c = _default_catalog
    if c is None:
        if not resolve_armed(None):
            return fn(*args, **(kwargs or {}))
        c = default_catalog()
    return c.run(name, fn, args, kwargs)


# -- live-buffer census ------------------------------------------------------


def _allocated_bytes() -> Optional[int]:
    """The caching allocator's current bytes over every CUDA device, or
    None where there is no CUDA (no allocator total to report)."""
    try:
        if not torch.cuda.is_available():
            return None
        return int(sum(torch.cuda.memory_allocated(i)
                       for i in range(torch.cuda.device_count())))
    except Exception:
        return None


class LiveBufferCensus:
    """Sampler over the tensors of registered source tags, bucketed by
    (tag, shape, dtype), with the allocator's remainder ``untagged``.

    Tags are zero-arg suppliers returning a tensor tree (``lambda:
    (self.params, self.opt_state)``), resolved fresh at every sample, so
    the census holds no references between samples and a swapped tree is
    re-resolved, not pinned.  A storage shared by several views (or
    claimed by two tags) counts once, for the first tag that claims it.
    Per-tag budgets (plus ``total``) feed the ``hbm_pressure`` detector
    through the same worst-fraction machinery as the resources plane.
    ``maybe_sample()`` is the per-step hook — a counter bump with a full
    sample every ``sample_every`` calls."""

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 monitor: Optional[health_mod.HealthMonitor] = None,
                 budgets: Optional[Dict[str, float]] = None,
                 name: str = "census", sample_every: int = 16,
                 top_k: int = 8, register: bool = True,
                 detector_overrides: Optional[Dict] = None):
        self.name = str(name)
        self.registry = registry if registry is not None else default_registry()
        self.monitor = monitor
        if monitor is not None:
            ensure_device_detectors(monitor, **dict(detector_overrides or {}))
        self.sample_every = int(sample_every)
        self.top_k = int(top_k)
        self._lock = threading.Lock()
        self._suppliers: Dict[str, Callable] = {}
        self.budgets: Dict[str, float] = {
            str(k): float(v) for k, v in (budgets or {}).items()}
        self._calls = 0
        self._last: Dict = {}
        self._registered = bool(register)
        if self._registered:
            flight_mod.register_registry(f"device:census:{self.name}", self)
            register_provider(f"census:{self.name}", self.payload)

    def close(self) -> None:
        if self._registered:
            flight_mod.unregister_registry(f"device:census:{self.name}")
            unregister_provider(f"census:{self.name}")
            self._registered = False

    def register_tag(self, tag: str, supplier: Callable) -> None:
        """``supplier()`` returns the tensor tree whose storages belong to
        ``tag`` (resolved fresh every sample)."""
        with self._lock:
            self._suppliers[str(tag)] = supplier

    def remove_tag(self, tag: str) -> None:
        with self._lock:
            self._suppliers.pop(str(tag), None)

    def set_budget(self, tag: str, budget_bytes: Optional[float]) -> None:
        with self._lock:
            if budget_bytes is None:
                self.budgets.pop(str(tag), None)
            else:
                self.budgets[str(tag)] = float(budget_bytes)

    def maybe_sample(self) -> None:
        with self._lock:
            self._calls += 1
            due = (self.sample_every > 0
                   and self._calls % self.sample_every == 0)
        if due:
            self.sample()

    def sample(self) -> Dict:
        """Walk the tagged tensors, publish the per-tag gauges, feed the
        ``hbm_pressure`` signal.  Returns the census summary."""
        with self._lock:
            suppliers = dict(self._suppliers)
            budgets = dict(self.budgets)
        seen = set()
        tags: Dict[str, List[float]] = {}
        buckets: Dict[Tuple[str, str, str], List[float]] = {}
        cuda_tagged = 0
        for tag, fn in suppliers.items():
            try:
                leaves = tensor_leaves(fn())
            except Exception:
                _LOG.debug("census supplier %r failed", tag, exc_info=True)
                continue
            t = tags.setdefault(tag, [0.0, 0])
            for leaf in leaves:
                if leaf.numel() == 0:
                    continue
                key = _storage_key(leaf)
                if key in seen:
                    continue
                seen.add(key)
                nb = float(leaf.untyped_storage().nbytes())
                if leaf.is_cuda:
                    cuda_tagged += int(nb)
                t[0] += nb
                t[1] += 1
                bkey = (tag, str(tuple(leaf.shape)), str(leaf.dtype))
                b = buckets.setdefault(bkey, [0.0, 0])
                b[0] += nb
                b[1] += 1
        tagged = int(sum(v[0] for v in tags.values()))
        count = int(sum(v[1] for v in tags.values()))
        allocated = _allocated_bytes()
        if allocated is not None:
            untagged: Optional[int] = max(0, allocated - cuda_tagged)
            total = allocated + (tagged - cuda_tagged)
        else:
            untagged = None
            total = tagged
        per_tag_bytes = {tag: int(v[0]) for tag, v in tags.items()}
        per_tag_bytes["total"] = int(total)
        if untagged is not None:
            per_tag_bytes["untagged"] = int(untagged)
        top = [
            {"tag": k[0], "shape": k[1], "dtype": k[2],
             "bytes": int(v[0]), "count": int(v[1])}
            for k, v in sorted(buckets.items(),
                               key=lambda kv: -kv[1][0])[:self.top_k]
        ]
        if gate.enabled():
            reg = self.registry
            for tag, v in tags.items():
                reg.gauge_set(labeled("device_live_buffer_bytes", tag=tag),
                              int(v[0]))
                reg.gauge_set(labeled("device_live_buffer_count", tag=tag),
                              int(v[1]))
            if untagged is not None:
                reg.gauge_set(
                    labeled("device_live_buffer_bytes", tag="untagged"),
                    int(untagged))
            reg.gauge_set(labeled("device_live_buffer_bytes", tag="total"),
                          int(total))
            reg.gauge_set(labeled("device_live_buffer_count", tag="total"),
                          count)
            for tag, b in budgets.items():
                reg.gauge_set(labeled("device_live_budget_bytes", tag=tag), b)
        tag_rows = {tag: {"bytes": int(v[0]), "count": int(v[1])}
                    for tag, v in sorted(tags.items())}
        summary = {
            "available": True,
            "total_bytes": int(total),
            "total_scope": "allocator" if allocated is not None else "tagged",
            "tagged_bytes": tagged,
            "untagged_bytes": ("unavailable" if untagged is None
                               else int(untagged)),
            "arrays": count,
            "tags": tag_rows,
            "top": top,
            "budgets": budgets,
        }
        with self._lock:
            self._last = summary
        # monitor feed OUTSIDE the lock: a trip can trigger a flight dump
        # that reads this census's own snapshot()
        if (self.monitor is not None and budgets
                and self.monitor.wants("hbm_pressure")):
            self.monitor.observe(hbm_pressure={
                "bytes": per_tag_bytes, "budgets": budgets})
        return summary

    def snapshot(self, reset: bool = False) -> Dict:
        with self._lock:
            return {"device": True, "census": self.name, **self._last}

    def payload(self) -> Dict:
        return self.snapshot()


# -- donation verification ---------------------------------------------------


class DonationWatch:
    """Counters + health feed for in-place (donation) checks.

    :func:`verify_donation` wrappers report here; the watch publishes
    ``device_donation_checks_total`` / ``device_donation_miss_total``
    per program and feeds the ``donation`` signal to the
    :class:`DonationMissDetector`."""

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 monitor: Optional[health_mod.HealthMonitor] = None,
                 name: str = "donation", register: bool = True):
        self.name = str(name)
        self.registry = registry if registry is not None else default_registry()
        self.monitor = monitor
        if monitor is not None:
            ensure_device_detectors(monitor)
        self._lock = threading.Lock()
        self._programs: Dict[str, List[int]] = {}
        self._registered = bool(register)
        if self._registered:
            flight_mod.register_registry(f"device:{self.name}", self)
            register_provider(self.name, self.payload)

    def close(self) -> None:
        if self._registered:
            flight_mod.unregister_registry(f"device:{self.name}")
            unregister_provider(self.name)
            self._registered = False

    def bind(self, registry: Optional[MetricsRegistry] = None,
             monitor: Optional[health_mod.HealthMonitor] = None) -> None:
        """Late wiring for the process-default watch (a trainer arms the
        device plane after the wrap sites were built — latest wins)."""
        if registry is not None:
            self.registry = registry
        if monitor is not None:
            self.monitor = monitor
            ensure_device_detectors(monitor)

    def note(self, program: str, aliased: bool, donated: int = 0) -> None:
        program = str(program)
        with self._lock:
            c = self._programs.setdefault(program, [0, 0])
            c[0] += 1
            if not aliased:
                c[1] += 1
        if gate.enabled():
            self.registry.inc(
                labeled("device_donation_checks_total", program=program))
            if not aliased:
                self.registry.inc(
                    labeled("device_donation_miss_total", program=program))
        if self.monitor is not None and self.monitor.wants("donation"):
            self.monitor.observe(donation={
                "program": program, "miss": not aliased,
                "donated": int(donated)})

    def snapshot(self, reset: bool = False) -> Dict:
        with self._lock:
            return {
                "device": True,
                "donation": True,
                "programs": {
                    name: {"checks": c[0], "misses": c[1]}
                    for name, c in sorted(self._programs.items())
                },
            }

    def payload(self) -> Dict:
        return self.snapshot()


_watch_lock = threading.Lock()
_default_watch: Optional[DonationWatch] = None


def default_donation_watch() -> DonationWatch:
    """The process-wide donation watch (wrap-site sugar; a trainer binds
    its registry/monitor in at arm time).  Lazy."""
    global _default_watch
    with _watch_lock:
        if _default_watch is None:
            _default_watch = DonationWatch()
        return _default_watch


def reset_default_donation_watch() -> None:
    """Drop the process donation watch (tests)."""
    global _default_watch
    with _watch_lock:
        if _default_watch is not None:
            _default_watch.close()
            _default_watch = None


def verify_donation(program: str, fn, donate_argnums=(),
                    watch: Optional[DonationWatch] = None,
                    sample_every: int = 8):
    """Wrap a callable that promises to update some inputs in place with
    verification of that promise.

    Every ``sample_every``-th call records the storage pointers of the
    tensors in the ``donate_argnums`` arguments before the call and checks
    after it that each input still holds that storage and that the
    storage comes back among the outputs — the storage written.  An input
    whose storage is nowhere in the outputs was copied (the update
    declined to write in place): a ``donation_miss``.  Zero-size tensors
    hold no storage and are skipped.

    Returns ``fn`` UNCHANGED when the device plane is disarmed and no
    explicit ``watch`` is given (the dark path stays zero-cost), or when
    nothing is donated.  ``._cache_size`` passes through so the wrapper
    still registers with the compile tracker."""
    if watch is None and not resolve_armed(None):
        return fn
    donate = tuple(int(i) for i in (donate_argnums or ()))
    if not donate:
        return fn
    program = str(program)
    every = max(1, int(sample_every))
    state = {"n": 0}

    def wrapped(*args, **kwargs):
        state["n"] += 1
        before = None
        if (state["n"] - 1) % every == 0:
            before = [(leaf, _storage_key(leaf))
                      for i in donate if i < len(args)
                      for leaf in tensor_leaves(args[i]) if leaf.numel()]
        out = fn(*args, **kwargs)
        if before:
            out_keys = {_storage_key(t) for t in tensor_leaves(out)
                        if t.numel()}
            missed = [key for leaf, key in before
                      if _storage_key(leaf) != key or key not in out_keys]
            w = watch if watch is not None else default_donation_watch()
            w.note(program, aliased=not missed, donated=len(before))
        return out

    a = getattr(fn, "_cache_size", None)
    if a is not None:
        wrapped._cache_size = a
    wrapped.__wrapped__ = fn
    wrapped.__name__ = getattr(fn, "__name__", program)
    return wrapped


# -- profiler capture --------------------------------------------------------

#: detectors whose bad transition auto-arms a one-shot capture
AUTO_CAPTURE_TRIGGERS = ("stall", "memory_pressure", "hbm_pressure")


class ProfileTrigger:
    """On-demand ``torch.profiler`` capture over the next N steps.

    ``POST /profilez[?steps=N]`` (or :meth:`arm`) requests a capture;
    the trace starts at the next :func:`profile_step` boundary and stops
    N step boundaries later, so a capture covers whole steps; it lands as
    a Chrome trace (``trace.json``) in ``capture-NNNN/`` under the base
    dir.  Refusals are clean and typed: 409 when ``torch.profiler`` is
    unavailable (:func:`~lightctr_tpu_torch.utils.profiling.
    profiler_available`), 409 when a capture is already armed or active —
    this trigger's, or any other ``torch.profiler`` session in the
    process (only one can run) — and 429 inside the rate window
    (``min_interval_s`` since the last arm).  The capture dir is bounded:
    only the newest ``max_captures`` are kept.  Anomaly coupling:
    :func:`install_auto_capture` arms a one-shot capture when a
    :data:`AUTO_CAPTURE_TRIGGERS` detector goes bad
    (``LIGHTCTR_PROFILE_AUTO=1`` at obs import)."""

    def __init__(self, base_dir: Optional[str] = None,
                 registry: Optional[MetricsRegistry] = None,
                 min_interval_s: Optional[float] = None,
                 max_captures: int = 4, default_steps: int = 3,
                 register: bool = True,
                 clock: Callable[[], float] = time.monotonic):
        if base_dir is None:
            base_dir = os.environ.get("LIGHTCTR_PROFILE_DIR")
        if base_dir is None:
            import tempfile
            base_dir = os.path.join(tempfile.gettempdir(),
                                    "lightctr_profiles")
        self.base_dir = str(base_dir)
        self.registry = registry if registry is not None else default_registry()
        if min_interval_s is None:
            try:
                min_interval_s = float(
                    os.environ.get("LIGHTCTR_PROFILE_MIN_S", "60"))
            except ValueError:
                min_interval_s = 60.0
        self.min_interval_s = float(min_interval_s)
        self.max_captures = int(max_captures)
        self.default_steps = int(default_steps)
        self._clock = clock
        self._lock = threading.Lock()
        self._armed_steps: Optional[int] = None
        self._remaining = 0
        self._active_dir: Optional[str] = None
        self._session = None
        self._reason: Optional[str] = None
        self._last_arm: Optional[float] = None
        self._captures: List[Dict] = []
        self._seq = 0
        # fast flag: profile_step() reads this before taking any lock
        self._engaged = False
        self._registered = bool(register)
        if self._registered:
            exporter_mod.register_post_route("/profilez", self.handle_post)
            register_provider("profile", self.payload)

    def close(self) -> None:
        with self._lock:
            active = self._active_dir is not None
            self._armed_steps, self._remaining = None, 0
            self._engaged = False
        if active:
            self._stop_trace()
        if self._registered:
            exporter_mod.unregister_post_route("/profilez")
            unregister_provider("profile")
            self._registered = False

    # -- arming --------------------------------------------------------------

    def available(self) -> Tuple[bool, str]:
        from lightctr_tpu_torch.utils import profiling
        return profiling.profiler_available()

    def _refuse(self, reason: str, detail: Dict) -> Tuple[bool, Dict]:
        if gate.enabled():
            self.registry.inc(
                labeled("device_profile_refused_total", reason=reason))
        return False, {"refused": reason, **detail}

    def arm(self, steps: Optional[int] = None,
            reason: str = "ops") -> Tuple[bool, Dict]:
        """Request a capture of the next ``steps`` steps.  Returns
        ``(ok, info)``; a refusal never raises — the auto-arm path runs
        inside health emission."""
        from lightctr_tpu_torch.utils import profiling

        n = self.default_steps if not steps else int(steps)
        n = max(1, min(n, 1000))
        ok, why = self.available()
        if not ok:
            return self._refuse("unavailable", {"detail": why})
        now = self._clock()
        with self._lock:
            if self._armed_steps is not None or self._active_dir is not None:
                return self._refuse("busy", {"detail": "capture in progress"})
            if profiling.capture_active():
                return self._refuse("busy", {
                    "detail": "another torch.profiler capture is active"})
            if (self._last_arm is not None
                    and now - self._last_arm < self.min_interval_s):
                return self._refuse("rate_limited", {
                    "retry_after_s": round(
                        self.min_interval_s - (now - self._last_arm), 3)})
            self._last_arm = now
            self._armed_steps = n
            self._reason = str(reason)
            self._engaged = True
        events_mod.emit("profile_arm", steps=n, reason=str(reason))
        return True, {"steps": n, "reason": str(reason),
                      "dir": self.base_dir}

    # -- step feed -----------------------------------------------------------

    def engaged(self) -> bool:
        return self._engaged

    def on_step(self) -> None:
        """Step-boundary hook: start an armed capture, count down an
        active one, stop+finalize when it has covered its steps."""
        from lightctr_tpu_torch.utils import profiling

        with self._lock:
            if self._armed_steps is not None and self._active_dir is None:
                n, reason = self._armed_steps, self._reason
                self._armed_steps = None
                self._seq += 1
                cap_dir = os.path.join(self.base_dir,
                                       f"capture-{self._seq:04d}")
                start, stop = True, False
            elif self._active_dir is not None:
                self._remaining -= 1
                start = False
                stop = self._remaining <= 0
                cap_dir, n, reason = self._active_dir, 0, self._reason
            else:
                self._engaged = False
                return
        if start:
            session = profiling.Session(cap_dir)
            try:
                session.start()
            except Exception as e:
                _LOG.warning("profiler capture failed to start: %s", e)
                events_mod.emit("profile_capture", dir=cap_dir,
                                error=str(e), reason=reason)
                with self._lock:
                    self._engaged = False
                if gate.enabled():
                    self.registry.inc(labeled(
                        "device_profile_refused_total", reason="start_failed"))
                return
            with self._lock:
                self._active_dir = cap_dir
                self._session = session
                self._remaining = n
            return
        if stop:
            self._stop_trace()

    def _stop_trace(self) -> None:
        with self._lock:
            cap_dir, reason = self._active_dir, self._reason
            session, self._session = self._session, None
            self._active_dir, self._reason = None, None
            self._engaged = False
        trace_path = session.stop() if session is not None else None
        files = 0
        if cap_dir:
            for _root, _dirs, names in os.walk(cap_dir):
                files += len(names)
        if gate.enabled():
            self.registry.inc("device_profile_captures_total")
        events_mod.emit("profile_capture", dir=cap_dir, files=files,
                        reason=reason)
        with self._lock:
            self._captures.append({"dir": cap_dir, "files": files,
                                   "reason": reason, "trace": trace_path})
            evict = [c["dir"] for c in self._captures[:-self.max_captures]]
            self._captures = self._captures[-self.max_captures:]
        # bounded capture dir: drop the oldest landed captures
        for old in evict:
            shutil.rmtree(old, ignore_errors=True)

    # -- surfaces ------------------------------------------------------------

    def handle_post(self, query: Dict[str, list]) -> Tuple[int, Dict]:
        """The ``POST /profilez`` handler (exporter post route)."""
        steps = None
        try:
            steps = int(query.get("steps", ["0"])[0]) or None
        except (ValueError, IndexError):
            steps = None
        ok, info = self.arm(steps=steps, reason="ops:profilez")
        if ok:
            return 200, {"armed": info}
        code = {"unavailable": 409, "busy": 409,
                "rate_limited": 429}.get(info.get("refused"), 409)
        return code, {"error": f"profile capture refused: "
                               f"{info.get('refused')}", **info}

    def payload(self) -> Dict:
        with self._lock:
            return {
                "device": True,
                "dir": self.base_dir,
                "armed_steps": self._armed_steps,
                "active": self._active_dir,
                "remaining": self._remaining,
                "min_interval_s": self.min_interval_s,
                "captures": list(self._captures),
            }

    def snapshot(self, reset: bool = False) -> Dict:
        return self.payload()


_trigger_lock = threading.Lock()
_trigger: Optional[ProfileTrigger] = None


def profile_trigger(**kwargs) -> ProfileTrigger:
    """The process profiler trigger (lazy; kwargs only apply to the
    creating call)."""
    global _trigger
    with _trigger_lock:
        if _trigger is None:
            _trigger = ProfileTrigger(**kwargs)
        return _trigger


def reset_profile_trigger() -> None:
    """Drop the process trigger (tests)."""
    global _trigger
    with _trigger_lock:
        if _trigger is not None:
            _trigger.close()
            _trigger = None


def profile_step() -> None:
    """Per-step hook every trainer calls unconditionally: one global +
    one flag read when no capture is armed (the common case)."""
    t = _trigger
    if t is not None and t._engaged:
        t.on_step()


def _on_anomaly(component: str, detector: str, prev: str, new: str,
                detail: Dict) -> None:
    if detector not in AUTO_CAPTURE_TRIGGERS:
        return
    if health_mod.SEVERITY.get(new, 0) <= health_mod.SEVERITY[health_mod.OK]:
        return
    ok, info = profile_trigger().arm(
        reason=f"auto:{component}:{detector}")
    if not ok:
        _LOG.debug("auto profile capture refused: %s", info)


def install_auto_capture() -> None:
    """Arm anomaly-coupled capture: a bad ``stall`` / ``memory_pressure``
    / ``hbm_pressure`` transition one-shot-arms the profiler (refusals
    log at debug; the rate window applies)."""
    health_mod.register_anomaly_listener(_on_anomaly)


def uninstall_auto_capture() -> None:
    health_mod.unregister_anomaly_listener(_on_anomaly)


def maybe_auto_capture_from_env() -> None:
    """``LIGHTCTR_PROFILE_AUTO=1`` installs the anomaly auto-capture
    hook (obs/__init__ calls this once at import)."""
    v = os.environ.get("LIGHTCTR_PROFILE_AUTO", "").strip().lower()
    if v not in ("", "0", "false", "off", "no"):
        install_auto_capture()


# -- cluster rollup extraction ----------------------------------------------


def device_rollup(members: Dict[str, Dict]) -> Dict:
    """Extract the per-member device series from a cluster rollup dump.

    ``members`` is ``ClusterRollup.members()``-shaped.  Returns
    per-member ``device_*`` gauges/counters plus cluster verdicts: the
    lowest compute utilization program (``lowest_utilization`` — the
    first place to look when a host lags), the member with donation
    misses (``donation_misses``), and the biggest live-buffer tag
    (``biggest_live``)."""
    from lightctr_tpu_torch.obs.quality import _parse_labels

    out: Dict = {"members": {}, "lowest_utilization": None,
                 "donation_misses": None, "biggest_live": None}
    lowest: Optional[Tuple[str, str, float]] = None
    misses: Optional[Tuple[str, str, float]] = None
    biggest: Optional[Tuple[str, str, float]] = None
    for member, entry in sorted((members or {}).items()):
        snap = (entry or {}).get("snapshot") or {}
        rec: Dict = {"gauges": {}, "counters": {}}
        for kind in ("gauges", "counters"):
            for series, value in (snap.get(kind) or {}).items():
                name, labels = _parse_labels(series)
                if not name.startswith("device_"):
                    continue
                rec[kind][series] = value
                if name == "device_program_utilization":
                    prog = labels.get("program", "?")
                    if lowest is None or float(value) < lowest[2]:
                        lowest = (member, prog, float(value))
                elif name == "device_donation_miss_total":
                    prog = labels.get("program", "?")
                    if float(value) > 0 and (
                            misses is None or float(value) > misses[2]):
                        misses = (member, prog, float(value))
                elif name == "device_live_buffer_bytes":
                    tag = labels.get("tag", "?")
                    if tag != "total" and (
                            biggest is None or float(value) > biggest[2]):
                        biggest = (member, tag, float(value))
        if rec["gauges"] or rec["counters"]:
            out["members"][member] = rec
    if lowest is not None:
        out["lowest_utilization"] = {"member": lowest[0],
                                     "program": lowest[1],
                                     "utilization": round(lowest[2], 6)}
    if misses is not None:
        out["donation_misses"] = {"member": misses[0], "program": misses[1],
                                  "misses": int(misses[2])}
    if biggest is not None:
        out["biggest_live"] = {"member": biggest[0], "tag": biggest[1],
                               "bytes": int(biggest[2])}
    return out
