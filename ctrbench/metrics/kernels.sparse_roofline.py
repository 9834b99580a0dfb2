"""The sparse path's least time over its kernels' device time, %: the
larger of its bytes at the HBM peak and its operations at the float32
peak (roofline.py: ids read once, gradient rows read once, touched rows
and accumulators read and written once; bytes bind), over
``kernels.ms_per_step``."""

import os

from ctrbench import roofline
from ctrbench.run import load_module

_kernels = load_module(os.path.join(os.path.dirname(__file__),
                                    "kernels.ms_per_step.py"),
                       "ctrbench_metrics_kernels_ms_per_step")


def read(summary):
    s = _kernels.seconds_per_step(summary)
    if s is None:
        return None
    w = summary["work"]
    return 100.0 * roofline.least_time(w["sparse_flops"],
                                       w["sparse_bytes"])["seconds"] / s
