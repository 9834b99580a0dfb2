"""The long-run walk's run list and schedule (csrc/segment_runs.cuh), in
the numpy model of ``segment_runs_model``: the list's room and the places
of the doubles hold for every input shape the card tests use, and the
ticket puts no more than about the longest run on one walker at the
Criteo layout, where the fixed assignment of tiles to walkers piled the
13 whole-batch numeric runs onto one.  The card runs the same inputs in
``tests/test_torch_cuda.py`` (``-k long_run``)."""

import numpy as np
import pytest

import segment_runs_model as model
from lightctr_tpu_torch.ops import sparse_kernels as sk


def check_list(lst: dict) -> None:
    assert (lst["count"] <= lst["capacity"]).all()
    assert (lst["rank"] < model.header_int("kTileLongRuns")).all()
    assert (lst["bucket"] >= model.header_int("kFirstBucket")).all()
    assert np.unique(lst["place"]).size == lst["place"].size
    assert lst["place"].size == 0 or lst["place"].max() < lst["room"]


@pytest.mark.parametrize("d", [1, 10, 32])
def test_ticket_spreads_criteo_numeric_runs(d):
    """One 65,536-row batch of the Criteo layout: the list fits its room,
    every double has a place of its own, and under the ticket the busiest
    walker takes at most 1.3 times the longest run (a run is one walker's
    whole), where the fixed assignment put several times that on one."""
    ids = model.criteo_ids(65536, d).reshape(-1)
    starts, ends, _ = model.runs_of(ids, model.criteo_vocab())
    lst = model.run_list(starts, ends, ids.size, model.criteo_vocab(), d)
    check_list(lst)
    longest = int(lst["length"].max())
    assert longest == 65536  # a numeric field's id, in every row
    assert int((lst["length"] == longest).sum()) >= model.N_NUMERIC
    for seed in range(3):
        assert model.ticket_slots(lst, seed).max() <= 1.3 * longest
    if d != 10:  # at d 10 the tile (204 slots) scatters the runs' tiles
        assert model.fixed_slots(lst).max() >= 3 * longest


@pytest.mark.parametrize("d", [1, 32])
@pytest.mark.parametrize("case", model.EDGE_CASES)
def test_run_list_edge_cases(case, d):
    """The card tests' edge cases: the list fits its room and every double
    has a place; the ticket's busiest walker stays within Graham's bound
    (the long-run slots over the walkers, plus the longest run)."""
    inv, nseg = model.edge_case(case)
    starts, ends, _ = model.runs_of(inv, nseg)
    lst = model.run_list(starts, ends, inv.size, nseg, d)
    check_list(lst)
    n = lst["length"].size
    if case == "no_long_run":
        assert n == 0
        return
    assert n >= 1
    if case == "tile_of_long_runs":
        assert lst["rank"].max() >= 1
    if case == "spanning_run":
        span = lst["length"].max()
        assert span >= 20000 and span > 10 * model.walk_tile(d)
    if case == "one_run":
        assert n == 1 and lst["length"][0] == inv.size
    slots = model.ticket_slots(lst)
    bound = lst["length"].sum() / model.header_int("kLongBlocks") \
        + lst["length"].max()
    assert slots.max() <= bound and slots.sum() == lst["length"].sum()


def test_header_bounds_hold():
    """kTileLongRuns bounds the long runs one tile can start (all but the
    last lie inside it, each longer than kWalkLong); the buckets start
    where a long run's length has its top bit; the counters follow the
    bucket counts and the ticket."""
    long_, tile = model.header_int("kWalkLong"), model.header_int(
        "kWalkThreads")
    per_tile = model.header_int("kTileLongRuns")
    assert (per_tile - 1) * (long_ + 1) < tile <= per_tile * (long_ + 1)
    first = model.header_int("kFirstBucket")
    assert 1 << first <= long_ + 1 < 2 << first
    buckets = model.header_int("kRunBuckets")
    assert model.header_int("kRunWords") == buckets + 4
    assert [model.header_int(k) for k in ("kRunTicket", "kRunsWalked",
                                         "kBusiestWalker", "kLongestRun")] \
        == [buckets, buckets + 1, buckets + 2, buckets + 3]
    # the counters' reader in ops/sparse_kernels.py
    assert (sk._RUN_BUCKETS, sk._RUN_WORDS) == (buckets, buckets + 4)
