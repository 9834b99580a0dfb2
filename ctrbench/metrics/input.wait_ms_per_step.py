"""The program's ``trainer/input_wait`` span, ms a step, in the profiled
steps: the host's wait for the step's stream before the batch's pageable
host-to-device copy (the copy waits for it anyway; the span makes the
wait explicit).  Long where the card is behind the host."""

SPAN = "trainer/input_wait"


def read(summary):
    prof = summary["profiled"]
    s = prof["spans"].get(SPAN)
    if not s or not prof["steps"]:
        return None
    return 1e3 * s[0] / prof["steps"]
