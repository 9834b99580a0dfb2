"""obs — unified telemetry, copied from ``lightctr_tpu/obs``: metrics
registry, structured event log, causal span tracer, flight recorder,
health monitors, step stall watchdog, HTTP ops endpoints and queue
saturation telemetry.

``quality`` is the model-quality plane (the trainers' ``quality_bins=``
sketch, the server's ``drift=`` monitor, their detectors and
``/qualityz``).  ``resources`` is the resource & saturation plane (the
compile tracker over input signatures and kernel builds, queue
telemetry, memory pressure, ``/resourcez``; ``LIGHTCTR_RESOURCES=1`` arms
the trainers' watch), and ``device`` the device & program plane (program
cost/memory analytics with utilization against the card's peak, the
live-buffer census, in-place verification, ``torch.profiler`` capture on
``POST /profilez``, ``/devicez``; ``LIGHTCTR_DEVICE=1`` arms the
trainers' catalog and census).
"""

from lightctr_tpu_torch.obs.gate import enabled, override, set_enabled  # noqa: F401
from lightctr_tpu_torch.obs.registry import (  # noqa: F401
    DEFAULT_TIME_BUCKETS_S,
    MetricsRegistry,
    default_registry,
    histogram_quantile,
    labeled,
    merge_snapshots,
    render_prometheus,
)
from lightctr_tpu_torch.obs.events import emit as emit_event  # noqa: F401
from lightctr_tpu_torch.obs import trace  # noqa: F401
from lightctr_tpu_torch.obs import flight  # noqa: F401
from lightctr_tpu_torch.obs import health  # noqa: F401
from lightctr_tpu_torch.obs import stepwatch  # noqa: F401
from lightctr_tpu_torch.obs import exporter  # noqa: F401
from lightctr_tpu_torch.obs import resources  # noqa: F401
from lightctr_tpu_torch.obs import quality  # noqa: F401
from lightctr_tpu_torch.obs import device  # noqa: F401

# LIGHTCTR_PROFILE_AUTO=1 couples the profiler trigger to anomaly
# transitions (stall/memory_pressure/hbm_pressure one-shot captures)
device.maybe_auto_capture_from_env()

import logging as _logging


def ensure_console_logging(level: int = _logging.INFO) -> None:
    """Make the library's progress logging visible when the caller asked
    for it (``verbose=True``) but never configured Python logging: attaches
    one stream handler to the ``lightctr_tpu_torch`` logger, only when
    neither it nor the root logger has a handler."""
    log = _logging.getLogger("lightctr_tpu_torch")
    if not log.handlers and not _logging.getLogger().handlers:
        handler = _logging.StreamHandler()
        handler.setFormatter(_logging.Formatter("%(message)s"))
        log.addHandler(handler)
        log.setLevel(level)
