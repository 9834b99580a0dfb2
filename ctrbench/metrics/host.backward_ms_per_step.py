"""The program's ``trainer/backward`` span, ms a step, in the profiled
steps: ``loss.backward()`` on the step's thread, which waits there while
autograd's device thread launches the backward (B4 among it)."""

SPAN = "trainer/backward"


def read(summary):
    prof = summary["profiled"]
    s = prof["spans"].get(SPAN)
    if not s or not prof["steps"]:
        return None
    return 1e3 * s[0] / prof["steps"]
