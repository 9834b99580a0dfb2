"""The dense path's share of its roofline, %: the step's matrix products
(``gemm_flops``, forward and backward, counted from the shapes by the
system's ``work``) at the float32 peak, over the device time of cuBLAS's
GEMM and GEMV kernels (``dense.ms_per_step``)."""

import os

from ctrbench import roofline
from ctrbench.run import load_module

_dense = load_module(os.path.join(os.path.dirname(__file__),
                                  "dense.ms_per_step.py"),
                     "ctrbench_metrics_dense_ms_per_step")


def read(summary):
    ms = _dense.read(summary)
    flops = summary["work"].get("gemm_flops")
    if ms is None or not flops:
        return None
    least = roofline.least_time(flops, 0.0)["seconds"]
    return 100.0 * least / (1e-3 * ms)
