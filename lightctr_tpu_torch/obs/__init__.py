"""obs — unified telemetry, copied from ``lightctr_tpu/obs``: metrics
registry, structured event log, causal span tracer, flight recorder,
health monitors, HTTP ops endpoints and queue saturation telemetry.

The JAX package's quality, device and compile-tracking planes read jit
programs and device buffers the port does not have yet; they are not here.
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
from lightctr_tpu_torch.obs import trace  # noqa: F401
from lightctr_tpu_torch.obs import flight  # noqa: F401
from lightctr_tpu_torch.obs import health  # noqa: F401
from lightctr_tpu_torch.obs import exporter  # noqa: F401
from lightctr_tpu_torch.obs import resources  # noqa: F401
