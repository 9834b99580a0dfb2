"""The program's ``trainer/forward`` span, ms a step, in the profiled
steps: the model's loss on the gathered rows, as the host launches it."""

SPAN = "trainer/forward"


def read(summary):
    prof = summary["profiled"]
    s = prof["spans"].get(SPAN)
    if not s or not prof["steps"]:
        return None
    return 1e3 * s[0] / prof["steps"]
