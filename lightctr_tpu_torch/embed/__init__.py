"""Host-side parameter-server stores, copied from ``lightctr_tpu/embed``
(the flat, shm and tiered stores, the tiered store's cold log and its
frequency ledger), and the touched-row sparse Adagrad of
``embed.table``."""

from lightctr_tpu_torch.embed.async_ps import AsyncParamServer
from lightctr_tpu_torch.embed.ledger import FrequencyLedger
from lightctr_tpu_torch.embed.mmap_store import MmapRowStore
from lightctr_tpu_torch.embed.shm_ps import ShmAsyncParamServer
from lightctr_tpu_torch.embed.tiered import TieredEmbeddingStore

__all__ = [
    "AsyncParamServer",
    "FrequencyLedger",
    "MmapRowStore",
    "ShmAsyncParamServer",
    "TieredEmbeddingStore",
]
