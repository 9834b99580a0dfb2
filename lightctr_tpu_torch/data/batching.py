"""Batching utilities, copied from ``lightctr_tpu/data/batching.py``.

Replaces the reference's row-range thread partitioning
(``train_fm_algo.cpp:46-54``): batches are dictionaries of
equal-leading-dim arrays.  ``shard_for_hosts`` defaults to the
``torch.distributed`` process group's rank and size where the JAX function
reads ``jax.process_index()`` / ``process_count()``.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np


def minibatches(
    arrays: Dict[str, np.ndarray],
    batch_size: int,
    *,
    shuffle: bool = True,
    seed: int = 0,
    drop_remainder: bool = True,
) -> Iterator[Dict[str, np.ndarray]]:
    """Yield shuffled minibatch dicts (the reference shuffles row order each
    epoch, dl_algo_abst.h:62-66)."""
    n = len(next(iter(arrays.values())))
    idx = np.arange(n)
    if shuffle:
        np.random.default_rng(seed).shuffle(idx)
    end = n - (n % batch_size) if drop_remainder else n
    for s in range(0, end, batch_size):
        sel = idx[s: s + batch_size]
        yield {k: v[sel] for k, v in arrays.items()}


def shard_for_hosts(
    arrays: Dict[str, np.ndarray],
    host_id: Optional[int] = None,
    host_count: Optional[int] = None,
) -> Dict[str, np.ndarray]:
    """Rows for this host: row i belongs to host i % host_count.  Rows beyond
    the largest multiple of host_count are dropped so every host sees the same
    local shape (every rank steps the same program on the same shapes).
    Defaults: this process's rank and the world size of the initialised
    ``torch.distributed`` group, else host 0 of 1."""
    if host_id is None or host_count is None:
        import torch.distributed as dist

        up = dist.is_available() and dist.is_initialized()
        if host_id is None:
            host_id = dist.get_rank() if up else 0
        if host_count is None:
            host_count = dist.get_world_size() if up else 1
    n = len(next(iter(arrays.values())))
    even = n - (n % host_count)
    return {k: v[host_id:even:host_count] for k, v in arrays.items()}
