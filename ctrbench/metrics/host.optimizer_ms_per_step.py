"""The program's ``trainer/optimizer`` span, ms a step, in the profiled
steps: the update after the backward (the gradient norm, the dense
optimizer, the tables' touched-row Adagrad by B5, the health vector)."""

SPAN = "trainer/optimizer"


def read(summary):
    prof = summary["profiled"]
    s = prof["spans"].get(SPAN)
    if not s or not prof["steps"]:
        return None
    return 1e3 * s[0] / prof["steps"]
