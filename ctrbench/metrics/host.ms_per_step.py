"""The host clock around each ``train_step`` call, the mean over the
unprofiled window of the traced run, in ms.  In a closed loop the host
also waits here when the card is behind (a pageable copy waits for the
stream), so this reads the step time where the card binds."""

import statistics


def read(summary):
    host = summary["window"]["host_s"]
    return 1e3 * statistics.fmean(host) if host else None
