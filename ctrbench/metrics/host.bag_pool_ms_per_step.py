"""The program's ``embed/bag_pool`` span, ms a step, in the profiled
steps: the pooled lookup of the multi-hot bags (the rows' gather and
each feature's sum), as the host launches it."""

SPAN = "embed/bag_pool"


def read(summary):
    prof = summary["profiled"]
    s = prof["spans"].get(SPAN)
    if not s or not prof["steps"]:
        return None
    return 1e3 * s[0] / prof["steps"]
