"""Trace annotation, the port's counterpart of ``annotate`` in
``lightctr_tpu/utils/profiling.py``."""

from __future__ import annotations

import contextlib
from typing import Iterator

import torch

from lightctr_tpu_torch.obs import trace as _trace


@contextlib.contextmanager
def annotate(name: str, **attrs) -> Iterator[None]:
    """Named sub-region for traces: one name on the PyTorch profiler's
    timeline (``torch.profiler.record_function``, so the region shows
    around its kernels in a device trace) and in the obs span tracer (a
    span when tracing is sampled, ``attrs`` attached)."""
    with torch.profiler.record_function(name), _trace.span(name, **attrs):
        yield
