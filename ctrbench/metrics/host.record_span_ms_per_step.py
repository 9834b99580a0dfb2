"""The program's ``trainer/record`` span, ms a step, in the profiled steps:
``CTRTrainer._record_step`` (the step's counters and event, the health
feed with its signals); ``host.record_ms_per_step`` reads the same part as
a difference of spans."""

SPAN = "trainer/record"


def read(summary):
    prof = summary["profiled"]
    s = prof["spans"].get(SPAN)
    if not s or not prof["steps"]:
        return None
    return 1e3 * s[0] / prof["steps"]
