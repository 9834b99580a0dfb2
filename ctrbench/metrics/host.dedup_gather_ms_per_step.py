"""The program's ``sparse_tables/dedup_gather`` span, ms a step, in the
profiled steps: the sparse trainer's per-stream id dedup (B2), the
position rewrite and the touched rows' gather, as the host launches them."""

SPAN = "sparse_tables/dedup_gather"


def read(summary):
    prof = summary["profiled"]
    s = prof["spans"].get(SPAN)
    if not s or not prof["steps"]:
        return None
    return 1e3 * s[0] / prof["steps"]
