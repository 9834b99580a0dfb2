"""Serving plane: batched low-latency inference over the PS wire.

The port's counterpart of ``lightctr_tpu/serve`` (docs/SERVING.md):

  - :class:`~lightctr_tpu_torch.serve.model.ServingModel` — the batched
    score path on one device, with optional PS-row-backed sparse leaves;
  - :class:`~lightctr_tpu_torch.serve.cache.HotEmbeddingCache` —
    LFU-admission row cache in front of PS pulls, invalidated on PS write
    versions, its rows one device tensor read by the ``gather_rows``
    kernel;
  - :class:`~lightctr_tpu_torch.serve.server.PredictionServer` — the
    ``MSG_PREDICT``/``MSG_PREDICT_BATCH`` socket service with
    micro-batching and admission control / load shedding;
  - :class:`~lightctr_tpu_torch.serve.client.PredictClient` — the caller
    stub.
"""

from lightctr_tpu_torch.serve.cache import HotEmbeddingCache
from lightctr_tpu_torch.serve.client import PredictClient, ServerOverloaded
from lightctr_tpu_torch.serve.model import (
    MODEL_KINDS,
    ServingModel,
    fm_ps_row_leaves,
    fused_fm_rows,
)
from lightctr_tpu_torch.serve.server import PredictionServer

__all__ = [
    "HotEmbeddingCache",
    "MODEL_KINDS",
    "PredictClient",
    "PredictionServer",
    "ServerOverloaded",
    "ServingModel",
    "fm_ps_row_leaves",
    "fused_fm_rows",
]
