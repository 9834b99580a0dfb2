"""Online learning plane: the continuous train-and-serve loop (the port's
counterpart of ``lightctr_tpu/online``; the gradient step runs on the
card, pulls and pushes stay host numpy over the PS client).

The rest of the repo trains a run and serves a snapshot; this package
closes the reference's actual loop (``Distributed_Algo_Abst``'s online PS
worker, PAPER.md) — training never stops, and serving tracks it under a
freshness SLO (docs/ONLINE.md):

  - :class:`~lightctr_tpu_torch.online.trainer.OnlineTrainer` — indefinite
    pull->grad->push off a looping/tailing batch stream
    (``data.streaming.iter_libffm_batches(loop=True / follow=True)``),
    sparse rows server-resident (the SAME rows the serving plane scores
    from), dense half worker-local with periodic compressed exports;
  - :class:`~lightctr_tpu_torch.online.freshness.FreshnessSubscriber` —
    push-based serving freshness: a long-poll per PS shard on the
    ``MSG_SUBSCRIBE`` wire op drives per-key cache invalidation off the
    store's bounded write log (full-drop degrade preserved when a
    replica falls off the log floor), and feeds the replica's
    :class:`~lightctr_tpu_torch.obs.health.FreshnessSLODetector`;
  - :class:`~lightctr_tpu_torch.online.swap.ModelSwapper` /
    :func:`~lightctr_tpu_torch.online.swap.publish_export` — dense-model
    hot-swap gated by shadow-scoring parity on a held replay slice
    (corrupted exports are refused, counted, evented).

``ONLINE_SERIES`` declares every ``online_*`` / ``serve_freshness_*``
metric this package emits — the AST lint in tests/test_torch_online.py holds the
set exact in both directions, so no online counter ships dark.
"""

from lightctr_tpu_torch.online.freshness import FreshnessSubscriber
from lightctr_tpu_torch.online.swap import (
    ModelSwapper,
    publish_export,
    read_latest,
)
from lightctr_tpu_torch.online.trainer import OnlineTrainer

#: every metric series the online plane writes (lint-enforced exact)
ONLINE_SERIES = (
    # trainer (online/trainer.py)
    "online_steps_total",           # counter
    "online_examples_total",        # counter (real rows trained)
    "online_loss",                  # gauge, last step's loss
    "online_push_failures_total",   # counter (dropped/partial pushes)
    "online_exports_total",         # counter (dense artifacts published)
    "online_export_seconds",        # histogram
    # swap gate (online/swap.py)
    "online_swap_attempts_total",   # counter
    "online_swap_accepted_total",   # counter
    "online_swap_refused_total",    # counter, {reason}
    "online_swap_shadow_diff",      # gauge, last shadow max-abs-diff
    # freshness subscriber (online/freshness.py)
    "serve_freshness_polls_total",          # counter (long-poll rounds)
    "serve_freshness_deltas_applied_total",  # counter (log entries)
    "serve_freshness_rows_dropped_total",   # counter (cache rows)
    "serve_freshness_full_refresh_total",   # counter, {reason}
    "serve_freshness_age_seconds",          # gauge (newest applied age)
    "serve_freshness_apply_age_seconds",    # histogram (per-entry age)
)

__all__ = [
    "FreshnessSubscriber",
    "ModelSwapper",
    "ONLINE_SERIES",
    "OnlineTrainer",
    "publish_export",
    "read_latest",
]
