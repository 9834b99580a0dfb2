"""The host data plane: libFFM and dense loaders, the streaming reader,
synthetic writers, batching, the compiled shard cache and the ingest
prefetch stage (copies of ``lightctr_tpu/data``)."""

from lightctr_tpu_torch.data.batching import minibatches, shard_for_hosts
from lightctr_tpu_torch.data.dense import DenseDataset, load_dense_csv
from lightctr_tpu_torch.data.ingest import (
    INGEST_SERIES,
    FeatureSpec,
    ShardCache,
    ShardCorruption,
    as_arrays,
    compile_shards,
    iter_ingest_batches,
    iter_shard_batches,
    load_cache,
    prefetch_batches,
)
from lightctr_tpu_torch.data.sparse import SparseDataset, load_libffm

__all__ = [
    "SparseDataset",
    "load_libffm",
    "DenseDataset",
    "load_dense_csv",
    "minibatches",
    "shard_for_hosts",
    "INGEST_SERIES",
    "FeatureSpec",
    "ShardCache",
    "ShardCorruption",
    "as_arrays",
    "compile_shards",
    "iter_ingest_batches",
    "iter_shard_batches",
    "load_cache",
    "prefetch_batches",
]
