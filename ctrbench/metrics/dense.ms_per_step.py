"""Device time of the dense layers' products on cuBLAS (its GEMM and GEMV
kernels and their split-K reductions), ms a step, from the profiler."""

import re

PATTERN = re.compile(r"gemm|gemv|splitkreduce", re.IGNORECASE)


def read(summary):
    prof = summary["profiled"]
    total = sum(s for name, (s, _) in prof["device"].items()
                if PATTERN.search(name))
    if total <= 0 or not prof["steps"]:
        return None
    return 1e3 * total / prof["steps"]
