"""The card's idle share of the profiled window, %: 1 - (the union of its
operations' time) / (the window's length), the trace's ``busy_s`` and
``window_s``.  The profiler slows the host, so where the host is near
the bound this reads higher than an unwatched step would; taken against
the unprofiled step instead, the stretched pageable copies made it read
below zero."""


def read(summary):
    prof = summary["profiled"]
    if prof["busy_s"] <= 0 or prof["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
