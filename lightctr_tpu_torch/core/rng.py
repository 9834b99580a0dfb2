"""PRNG helpers over explicit ``torch.Generator`` objects.

The port's counterpart of ``lightctr_tpu/core/rng.py``.  The reference
uses a Box-Muller gaussian + uniform RNG (``util/random.h:17-60``) seeded
from time; the JAX package threads ``jax.random`` keys.  Here every draw
takes a ``torch.Generator``, so runs are reproducible per seed.  The bits
differ from ``jax.random``'s: what holds across the two packages is each
function's contract (distinct, in range, deterministic per seed).
"""

from __future__ import annotations

from typing import Iterator

import torch

#: generator seeds are drawn below this bound (the top of int64)
_SEED_BOUND = 1 << 62


def key_seq(seed: int) -> Iterator[torch.Generator]:
    """Infinite deterministic stream of fresh, independent (CPU)
    generators: each is seeded from a draw of one parent generator seeded
    with ``seed``."""
    parent = torch.Generator().manual_seed(seed)
    while True:
        sub = int(torch.randint(_SEED_BOUND, (), generator=parent))
        yield torch.Generator().manual_seed(sub)


def split_tree(generator: torch.Generator, tree):
    """One independent generator per leaf of ``tree`` (same structure: a
    dict, tuple, list or NamedTuple, nested), each seeded from a draw of
    ``generator``."""
    from lightctr_tpu_torch.optim.updaters import tree_map

    def leaf(_):
        sub = int(torch.randint(_SEED_BOUND, (), generator=generator,
                                device=generator.device))
        return torch.Generator(device=generator.device).manual_seed(sub)

    return tree_map(leaf, tree)


def shuffle_select_k(generator: torch.Generator, n: int,
                     k: int) -> torch.Tensor:
    """k distinct indices drawn from [0, n) (``shuffleSelectK``,
    random.h:97-114, a partial Fisher-Yates): a permutation's prefix, on
    the generator's device."""
    if k > n:
        raise ValueError(f"k={k} > n={n}")
    return torch.randperm(n, generator=generator,
                          device=generator.device)[:k]


def sub_sample_size(alpha: float = 0.05, error_bound: float = 0.05) -> int:
    """Statistical sample size for a confidence level and error bound
    (``subSampleSize``, random.h:86-95): n = z^2/4 / e^2 with z the
    two-sided normal quantile (worst-case p = 1/2)."""
    from lightctr_tpu_torch.ops.significance import z_value

    z = z_value(1.0 - alpha)
    return int((z * z / 4.0) / (error_bound * error_bound))
