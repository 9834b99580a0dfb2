"""Device time of the port's hand-written kernels on the sparse path
(``csrc/``: B2 dedup_ids, B4 merge_rows, B5 merge_apply and the radix
sort and segment walks they share), ms a step, from the profiler."""

import re

#: the kernels' symbols (csrc/dedup_ids.cu, merge_rows.cu, merge_apply.cu,
#: radix_sort.cuh, segment_runs.cuh)
SYMBOLS = ("make_keys", "rank_scatter", "radix_onesweep", "seg_keys",
           "walk_runs", "walk_long", "sum_partials", "apply_rows")
PATTERN = re.compile(r"\b(" + "|".join(SYMBOLS) + r")\b")


def seconds_per_step(summary):
    prof = summary["profiled"]
    total = sum(s for name, (s, _) in prof["device"].items()
                if PATTERN.search(name))
    if total <= 0 or not prof["steps"]:
        return None
    return total / prof["steps"]


def read(summary):
    s = seconds_per_step(summary)
    return None if s is None else 1e3 * s
