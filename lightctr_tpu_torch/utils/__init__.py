"""Utilities of the port: profiling hooks (``annotate``, ``trace``,
``wall_clock``) and the host and device memory readers."""

from lightctr_tpu_torch.utils.profiling import annotate, trace, wall_clock
from lightctr_tpu_torch.utils.system import (
    device_memory_stats,
    host_memory_usage,
)

__all__ = ["annotate", "trace", "wall_clock", "host_memory_usage",
           "device_memory_stats"]
