"""Batching utilities, copied from ``lightctr_tpu/data/batching.py``.

Replaces the reference's row-range thread partitioning
(``train_fm_algo.cpp:46-54``): batches are dictionaries of
equal-leading-dim arrays.  Only ``minibatches`` is here so far; the
multi-host ``shard_for_hosts`` comes with the multi-GPU slice.
"""

from __future__ import annotations

from typing import Dict, Iterator

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
