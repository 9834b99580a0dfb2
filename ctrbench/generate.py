"""The one traffic generator: a pool of Criteo-layout rows from a seed.

Each categorical field draws its ids from a power law over its own
published number of distinct values (``ids["cardinalities"]``, field by
field: the counts of Criteo-Kaggle's 26 categorical fields that DLRM's
and TorchRec's Kaggle preprocessing reports), a value of rank ``r`` with
the probability a continuous power law ``x ** -exponent`` puts on
``[r + 1, r + 2)``.  Each field is then hashed into a range of its own in
the table, as DLRM's ``--max-ind-range`` hashes its fields: a field keeps
``min(cardinality, cap)`` rows, with ``cap`` the largest that fits every
field and the numeric fields into the configuration's vocabulary, and a
value's row is ``(rank * HASH) mod rows`` (a bijection where the field
fits whole).  The numeric fields take one id each, after the categorical
ranges, with an exponential value rounded to three digits; categorical
values are 1.  A label is planted as a logistic in two numeric fields
plus an effect of the first field's row parity (``data/synth.py``'s
Criteo proxy).

The rows are drawn on ``device`` with a ``torch.Generator`` seeded from
the run's seed, in a few large calls, and handed over as host numpy
arrays, as a user's arrays are.  A traffic mix (``traffic/<mix>.json``)
says the batch, the pool's rows and the id distribution; the layout and
the vocabulary are the configuration's.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

#: the pool's generator stream, apart from the parameters' (``seed``)
POOL_STREAM = 1_000_003
#: Knuth's multiplicative hash (a prime): a field's rank to its row
HASH = 2_654_435_761


def generator(seed: int, device, stream: int = 0) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) + stream)
    return gen


def field_rows(cards: List[int], room: int) -> List[int]:
    """Each field's rows: ``min(card, cap)`` with ``cap`` the largest for
    which they sum to at most ``room``."""
    if sum(cards) <= room:
        return list(cards)
    lo, hi = 0, max(cards)
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if sum(min(c, mid) for c in cards) <= room:
            lo = mid
        else:
            hi = mid - 1
    if lo < 1:
        raise ValueError(f"{len(cards)} fields do not fit {room} rows")
    return [min(c, lo) for c in cards]


def categorical_ids(u: torch.Tensor, cards: List[int], exponent: float,
                    rows: List[int]) -> torch.Tensor:
    """``u`` ([n, fields] uniform float64) to each field's rows, int64."""
    dev = u.device
    n_vals = torch.tensor(cards, dtype=torch.float64, device=dev)
    n_rows = torch.tensor(rows, dtype=torch.int64, device=dev)
    base = torch.tensor(np.concatenate([[0], np.cumsum(rows)[:-1]]),
                        dtype=torch.int64, device=dev)
    a = 1.0 - float(exponent)
    if abs(a) < 1e-9:
        x = torch.exp(u * torch.log1p(n_vals))
    else:
        x = (u * (torch.pow(n_vals + 1.0, a) - 1.0) + 1.0).pow_(1.0 / a)
    rank = torch.minimum(x.floor_().to(torch.int64) - 1,
                         n_vals.to(torch.int64) - 1).clamp_(min=0)
    return (rank * HASH).remainder_(n_rows).add_(base)


def make_pool(traffic: Dict, cfg: Dict, seed: int,
              device) -> Dict[str, np.ndarray]:
    """``traffic["pool_rows"]`` rows: ``fids`` int32, ``vals``, ``mask``
    and ``labels`` float32, the first three ``[rows, fields]``."""
    layout = cfg["layout"]
    n_fields, n_cat = layout["fields"], layout["categorical"]
    n_num = n_fields - n_cat
    n, vocab = int(traffic["pool_rows"]), int(cfg["vocab"])
    ids = traffic["ids"]
    if ids["kind"] != "criteo_fields":
        raise ValueError(f"unknown id distribution {ids['kind']!r}")
    cards = [int(c) for c in ids["cardinalities"]]
    if len(cards) != n_cat:
        raise ValueError(f"{len(cards)} cardinalities for {n_cat} fields")
    rows = field_rows(cards, vocab - n_num)
    gen = generator(seed, device, POOL_STREAM)
    u = torch.rand((n, n_cat), generator=gen, dtype=torch.float64,
                   device=device)
    cat = categorical_ids(u, cards, float(ids["exponent"]), rows).to(
        torch.int32)
    del u
    numeric_ids = torch.arange(sum(rows), sum(rows) + n_num,
                               dtype=torch.int32,
                               device=device).expand(n, n_num)
    fids = torch.cat([cat, numeric_ids], dim=1)
    vals = torch.ones((n, n_fields), dtype=torch.float32, device=device)
    expo = torch.empty((n, n_num), dtype=torch.float32,
                       device=device).exponential_(generator=gen)
    vals[:, n_cat:] = torch.round(expo * 1000.0) / 1000.0
    z = ((vals[:, n_cat] - 1.0) + (vals[:, n_cat + 1] - 1.0)
         + (fids[:, 0] % 2).to(torch.float32) - 0.5)
    p = 1.0 / (1.0 + torch.exp(-2.0 * z))
    labels = (torch.rand(n, generator=gen, device=device) < p).to(
        torch.float32)
    pool = {"fids": fids, "vals": vals,
            "mask": torch.ones((n, n_fields), dtype=torch.float32,
                               device=device),
            "labels": labels}
    return {k: v.cpu().numpy() for k, v in pool.items()}


class Batches:
    """The pool's batches in order, cycled: batch ``i`` is rows
    ``[(i mod n) * batch, ...)``, views of the pool (no copy)."""

    def __init__(self, pool: Dict[str, np.ndarray], batch: int):
        rows = len(pool["labels"])
        if batch > rows:
            raise ValueError(f"batch {batch} exceeds the pool's {rows} rows")
        self.pool, self.batch, self.count = pool, int(batch), rows // batch

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        lo = (i % self.count) * self.batch
        return {k: v[lo:lo + self.batch] for k, v in self.pool.items()}
