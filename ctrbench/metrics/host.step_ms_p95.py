"""The 95th percentile over all steps of the unprofiled window of the
interval between consecutive step completions on the card (a CUDA event
after each step), ms: the tail of a host-paced step."""

import statistics


def read(summary):
    v = summary["window"]["intervals_ms"]
    if len(v) < 2:
        return None
    return statistics.quantiles(v, n=100, method="inclusive")[94]
