"""The host clock around ``train_step`` less the program's
``trainer/input`` and ``trainer/exec`` spans, ms a step, in the
profiled steps: what the step does after its work is enqueued (the
step's record, the health feed, its touched-id count on the host)."""

SPANS = ("trainer/input", "trainer/exec")


def read(summary):
    prof = summary["profiled"]
    spans = [prof["spans"].get(s) for s in SPANS]
    if not all(spans) or not prof["steps"]:
        return None
    rest = sum(prof["host_s"]) - sum(s[0] for s in spans)
    return 1e3 * rest / prof["steps"]
