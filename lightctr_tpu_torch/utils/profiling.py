"""Profiling hooks, the port's counterpart of
``lightctr_tpu/utils/profiling.py``.

The reference has wall-clock counters (``clock_start``/``clock_cycles``,
time.h:81-99) and DEBUG printf tracing; on the card the tool is
``torch.profiler`` (Kineto, CUPTI for the device), whose Chrome traces open
in Perfetto.

``trace(dir)`` captures a region into a Chrome trace and emits a
``trace_capture`` event through the obs event log, so captures are
discoverable from telemetry; ``wall_clock()`` reproduces the reference's
train-wall-clock counter pair; ``annotate(name)`` tags a sub-region on the
profiler's timeline and in the obs span tracer (obs/trace.py) under one
name, and costs one branch while neither records (:func:`spans_on`).

One ``torch.profiler`` session runs in a process at a time:
:func:`capture_active` says whether one is running (this module's, the
device plane's trigger, or any other caller's), and :func:`trace` and the
trigger refuse to start a second one.
"""

from __future__ import annotations

import contextlib
import logging
import os
import threading
import time
from typing import Iterator, Optional

import torch

from lightctr_tpu_torch.obs import events as _events
from lightctr_tpu_torch.obs import trace as _trace

_LOG = logging.getLogger(__name__)

#: held while this package runs a profiler session (trace() or the device
#: plane's trigger)
_session_lock = threading.Lock()


def profiler_available() -> "tuple[bool, str]":
    """Whether ``torch.profiler`` can capture here: ``(ok, why)``.  The
    device plane's ``POST /profilez`` checks this BEFORE arming, so a
    capture request on a worker without Kineto is a clean 409, not a
    mid-step exception."""
    try:
        profiler = torch.profiler
    except Exception as e:  # pragma: no cover - torch without a profiler
        return False, f"torch.profiler unavailable: {e}"
    if not callable(getattr(profiler, "profile", None)):
        return False, "torch.profiler has no profile"
    try:
        if not torch.autograd.kineto_available():
            return False, "torch.profiler: Kineto is not available"
    except Exception as e:
        return False, f"torch.profiler: {e}"
    return True, "ok"


def capture_active() -> bool:
    """Whether a ``torch.profiler`` session is running in this process
    (started here or by any other caller)."""
    if _session_lock.locked():
        return True
    # the module flag is process-wide (set by every torch.profiler
    # session); the C check is the calling thread's
    if getattr(torch.autograd.profiler, "_is_profiler_enabled", False):
        return True
    try:
        return bool(torch._C._autograd._profiler_enabled())
    except Exception:
        return False


def activities(device=None) -> list:
    """The profiler activities to record: the host always, the card when
    ``device`` is CUDA (or, with no ``device``, whenever CUDA is
    available)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device is not None:
        cuda = torch.device(device).type == "cuda"
    else:
        cuda = torch.cuda.is_available()
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


class Session:
    """One ``torch.profiler`` capture that holds the process's session
    slot: :meth:`start` refuses (``RuntimeError``) while another capture
    is active, :meth:`stop` writes ``trace.json`` (a Chrome trace) into
    ``log_dir`` and frees the slot."""

    def __init__(self, log_dir: str, device=None):
        self.log_dir = str(log_dir)
        self.device = device
        self.prof = None

    def start(self) -> None:
        if capture_active() or not _session_lock.acquire(blocking=False):
            raise RuntimeError("another torch.profiler capture is active")
        try:
            os.makedirs(self.log_dir, exist_ok=True)
            self.prof = torch.profiler.profile(
                activities=activities(self.device))
            self.prof.start()
        except Exception:
            self.prof = None
            _session_lock.release()
            raise

    def stop(self) -> Optional[str]:
        """Stop the capture; returns the trace file's path (None when the
        export failed, which is logged)."""
        prof, self.prof = self.prof, None
        if prof is None:
            return None
        try:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            prof.stop()
            path = os.path.join(self.log_dir, "trace.json")
            prof.export_chrome_trace(path)
            return path
        except Exception:
            _LOG.warning("torch.profiler failed to stop or export",
                         exc_info=True)
            return None
        finally:
            _session_lock.release()


@contextlib.contextmanager
def trace(log_dir: str, create_perfetto_link: bool = False,
          device=None) -> Iterator[None]:
    """``torch.profiler`` capture around a region, written as a Chrome
    trace (``trace.json``) into ``log_dir``; CUDA activity is recorded
    when ``device`` is CUDA (default: whenever CUDA is available).

    Emits a ``trace_capture`` event so the capture (and where it landed)
    shows up in the run's event log; degrades to a logged no-op when the
    profiler is unavailable or refuses to start (another capture active)
    — a worker asking for a profile must not crash, just not profile.
    ``create_perfetto_link`` is recorded on the event (the JAX package's
    argument; torch has no link server)."""
    ok, why = profiler_available()
    if not ok:
        _LOG.warning("%s: profiling.trace(%r) is a no-op", why, log_dir)
        _events.emit("trace_capture", log_dir=str(log_dir),
                     perfetto_link=bool(create_perfetto_link),
                     unavailable=True)
        yield
        return
    _events.emit("trace_capture", log_dir=str(log_dir),
                 perfetto_link=bool(create_perfetto_link))
    session = Session(log_dir, device=device)
    try:
        session.start()
    except Exception as e:
        # a profiler that refuses to start (a capture already running)
        # degrades the same way as an absent one: a logged no-op
        _LOG.warning("torch.profiler failed to start (%s): "
                     "profiling.trace(%r) is a no-op", e, log_dir)
        _events.emit("trace_capture", log_dir=str(log_dir),
                     perfetto_link=bool(create_perfetto_link),
                     unavailable=True, error=str(e))
        yield
        return
    try:
        yield
    finally:
        session.stop()


class wall_clock:
    """clock_start/clock_cycles parity (time.h:81-99): seconds since start.
    As a context manager, the elapsed time freezes at block exit so a later
    ``cycles()`` reports the timed region, not everything since."""

    def __init__(self):
        self._t0: Optional[float] = None
        self._t1: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()
        self._t1 = None

    def cycles(self) -> float:
        if self._t0 is None:
            raise RuntimeError("start() first")
        end = self._t1 if self._t1 is not None else time.perf_counter()
        return end - self._t0

    def __enter__(self) -> "wall_clock":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self._t1 = time.perf_counter()


#: the module whose global ``_is_profiler_enabled`` every ``torch.profiler``
#: session sets while it records (the flag :func:`capture_active` reads)
_autograd_profiler = torch.autograd.profiler
_NULL = contextlib.nullcontext()


def spans_on() -> bool:
    """Whether a phase span opened now would be recorded: a
    ``torch.profiler`` session is recording in this process, or the obs
    span tracer would record a span on this thread
    (:func:`~lightctr_tpu_torch.obs.trace.live`)."""
    return (getattr(_autograd_profiler, "_is_profiler_enabled", False)
            or _trace.live())


class _Annotation:
    """One ``annotate`` region while spans are on: a profiler annotation
    (a ``record_function`` region, ``user_annotation`` in the trace,
    entered through the binding ``torch.profiler``'s own annotations use,
    which skips the ``record_function`` class and the operator dispatch)
    while a profiler session records, and the obs span (a null context
    where the tracer does not sample)."""

    __slots__ = ("_name", "_span", "_rf")

    def __init__(self, name: str, attrs: dict):
        self._name = name
        self._span = _trace.span(name, **attrs)
        self._rf = None

    def __enter__(self) -> None:
        if getattr(_autograd_profiler, "_is_profiler_enabled", False):
            self._rf = torch.autograd._record_function_with_args_enter(
                self._name)
        self._span.__enter__()

    def __exit__(self, *exc) -> bool:
        self._span.__exit__(*exc)
        if self._rf is not None:
            torch.autograd._record_function_with_args_exit(self._rf)
        return False


def annotate(name: str, **attrs):
    """Named sub-region for traces: one name on the PyTorch profiler's
    timeline (a ``record_function`` region, so the region shows around
    its kernels in a device trace) and in the obs span tracer (a span
    when tracing is sampled, ``attrs`` attached).

    Spans are on while a ``torch.profiler`` session records (this
    module's :func:`trace`, ``POST /profilez``, or any other caller's) or
    while the obs tracer samples (:func:`spans_on`).  Otherwise this
    returns a shared null context after one branch: no profiler
    annotation is entered."""
    if not spans_on():
        return _NULL
    return _Annotation(name, attrs)
