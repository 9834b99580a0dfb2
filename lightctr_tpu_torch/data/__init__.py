"""The host data plane: libFFM and dense loaders, the streaming reader,
synthetic writers, batching and the ingest prefetch stage (copies of
``lightctr_tpu/data``; the shard cache is not ported yet)."""

from lightctr_tpu_torch.data.batching import minibatches, shard_for_hosts
from lightctr_tpu_torch.data.dense import DenseDataset, load_dense_csv
from lightctr_tpu_torch.data.ingest import prefetch_batches
from lightctr_tpu_torch.data.sparse import SparseDataset, load_libffm

__all__ = [
    "SparseDataset",
    "load_libffm",
    "DenseDataset",
    "load_dense_csv",
    "minibatches",
    "shard_for_hosts",
    "prefetch_batches",
]
