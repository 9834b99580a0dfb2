"""Utilities of the port: profiling hooks (``annotate``, ``trace``,
``wall_clock``)."""

from lightctr_tpu_torch.utils.profiling import annotate, trace, wall_clock

__all__ = ["annotate", "trace", "wall_clock"]
