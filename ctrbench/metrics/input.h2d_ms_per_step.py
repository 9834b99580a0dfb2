"""Device time of the batch's host-to-device copies (the trainer's
``_put``: ``Memcpy HtoD`` in the trace), ms a step, in the profiled
steps.  The copy's own time on the card: the host's wait for the stream
before it, which a faster kernel shortens, is not in it."""

PATTERN = "Memcpy HtoD"


def read(summary):
    prof = summary["profiled"]
    total = sum(s for name, (s, _) in prof["device"].items()
                if PATTERN in name)
    if total <= 0 or not prof["steps"]:
        return None
    return 1e3 * total / prof["steps"]
