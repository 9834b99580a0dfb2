"""The program's ``dlrm/cross`` span, ms a step, in the profiled steps:
the low-rank cross layers' forward, as the host launches it."""

SPAN = "dlrm/cross"


def read(summary):
    prof = summary["profiled"]
    s = prof["spans"].get(SPAN)
    if not s or not prof["steps"]:
        return None
    return 1e3 * s[0] / prof["steps"]
