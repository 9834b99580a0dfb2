"""A numpy model of the long-run walk of ``csrc/segment_runs.cuh``: the
runs a merge's sorted keys hold, the run list ``walk_runs`` builds (each
long run's bucket, its tile and its rank there, its double's place), and
the walkers' slots under the ticket (``walk_long``) and under the fixed
assignment of tiles to walkers it replaced.  The constants are read from
the header.  Also the id layout the tests share: Criteo's 26 categorical
fields drawn from power laws and its 13 numeric fields, one id each, in
every row.  Imports neither JAX nor the card."""

from __future__ import annotations

import heapq
import os
import re

import numpy as np

HEADER = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "lightctr_tpu_torch", "csrc", "segment_runs.cuh")

#: Criteo-Kaggle's distinct values of C1-C26 (as the benchmark's traffic
#: gives them), each field's range cut at CAT_CUT rows
CRITEO_CARDS = (1460, 583, 10131227, 2202608, 305, 24, 12517, 633, 3, 93145,
                5683, 8351593, 3194, 27, 14992, 5461306, 10, 5652, 2173, 4,
                7046547, 18, 15, 286181, 105, 142572)
CAT_CUT = 1 << 15
N_NUMERIC = 13


def header_int(name: str) -> int:
    """A ``constexpr int`` of the header, its expression evaluated over the
    header's other constants."""
    with open(HEADER) as f:
        text = f.read()
    found = re.search(rf"constexpr int {name} = ([^;]+);", text)
    if found is None:
        raise KeyError(name)
    expr = re.sub(r"//.*", "", found.group(1))
    expr = re.sub(r"\bk[A-Z]\w*", lambda m: str(header_int(m.group(0))), expr)
    return int(eval(expr.replace("/", "//"), {"__builtins__": {}}))


def walk_tile(d: int) -> int:
    t = header_int("kWalkItems") // max(d, 1)
    return max(8, min(t, header_int("kWalkThreads")))


def walk_blocks(m: int, nseg: int, d: int) -> int:
    return -(-max(m, nseg) // walk_tile(d))


def criteo_ids(rows: int, seed: int) -> np.ndarray:
    """[rows, 39] int32 ids: field f < 26 draws u^4 over its own range of
    min(card, CAT_CUT) ids (a power law, its low ids hot); the 13 numeric
    fields hold one id each, after the categorical ranges, in every row."""
    rng = np.random.default_rng(seed)
    sizes = np.minimum(np.asarray(CRITEO_CARDS), CAT_CUT)
    base = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    cat = base + (rng.random((rows, len(sizes))) ** 4 * sizes).astype(
        np.int64)
    num = np.broadcast_to(int(sizes.sum()) + np.arange(N_NUMERIC),
                          (rows, N_NUMERIC))
    return np.concatenate([cat, num], axis=1).astype(np.int32)


def criteo_vocab() -> int:
    return int(np.minimum(np.asarray(CRITEO_CARDS), CAT_CUT).sum()) \
        + N_NUMERIC


EDGE_CASES = ("tile_of_long_runs", "spanning_run", "one_run", "no_long_run",
              "empty_segments")


def edge_case(name: str, m: int = 40_000, nseg: int = 3000, seed: int = 5):
    """(inv, nseg) of one run-list edge case: several long runs starting
    in one tile (runs of 17 slots back to back); a run from one tile to
    many tiles later; every slot in one run (the coded padding); only runs
    of at most 16 slots; and segments that receive no kept row."""
    rng = np.random.default_rng(seed)
    if name == "tile_of_long_runs":
        inv = np.repeat(np.arange(m // 17 + 1), 17)[:m] % nseg
        return np.sort(inv).astype(np.int32), nseg
    if name == "spanning_run":
        inv = rng.integers(-2, nseg + 2, size=m)
        inv[1000:21000] = 7
        return inv.astype(np.int32), nseg
    if name == "one_run":
        return np.full(m, 11, np.int32), nseg
    if name == "no_long_run":
        return (np.arange(m) // 16 % nseg).astype(np.int32), nseg
    if name == "empty_segments":
        inv = rng.integers(0, nseg // 4, size=m)
        inv[:5000] = nseg // 8
        return inv.astype(np.int32), 4 * nseg
    raise KeyError(name)


def runs_of(inv: np.ndarray, nseg: int, zero_rows=None):
    """(start, end, key) of each run of kept slots after the key pass and
    the stable sort: key ``inv`` for a kept slot, ``nseg`` for a dropped or
    all-zero one (those sort last and make no run)."""
    inv = np.asarray(inv, np.int64).reshape(-1)
    keep = (inv >= 0) & (inv < nseg)
    if zero_rows is not None:
        keep &= ~np.asarray(zero_rows, bool)
    keys = np.sort(np.where(keep, inv, nseg), kind="stable")
    m = keys.size
    if m == 0:
        empty = np.zeros(0, np.int64)
        return empty, empty, empty
    starts = np.flatnonzero(np.r_[True, keys[1:] != keys[:-1]])
    ends = np.r_[starts[1:], m]
    kept = keys[starts] < nseg
    return starts[kept], ends[kept], keys[starts][kept]


def run_list(starts, ends, m: int, nseg: int, d: int) -> dict:
    """What ``walk_runs`` records of the long runs: each one's bucket (its
    length's top bit), its tile and rank among the tile's long runs, the
    place of its double, and the count a bucket against the list's room."""
    long_ = header_int("kWalkLong")
    is_long = (ends - starts) > long_
    s, e = starts[is_long], ends[is_long]
    length = e - s
    tile = s // walk_tile(d)
    rank = np.zeros(s.size, np.int64)
    for i in range(1, s.size):
        rank[i] = rank[i - 1] + 1 if tile[i] == tile[i - 1] else 0
    bucket = np.floor(np.log2(np.maximum(length, 1))).astype(np.int64)
    blocks = walk_blocks(m, nseg, d)
    per_tile = header_int("kTileLongRuns")
    return {"start": s, "end": e, "length": length, "tile": tile,
            "rank": rank, "bucket": bucket,
            "place": blocks + tile * per_tile + rank,
            "room": blocks * (1 + per_tile),
            "count": np.bincount(bucket, minlength=header_int("kRunBuckets")),
            "capacity": np.array([m >> k for k in range(
                header_int("kRunBuckets"))])}


def ticket_slots(lst: dict, seed: int = 0) -> np.ndarray:
    """The slots each walker takes under the ticket, a slot's time the
    same everywhere: the buckets from the longest down, any order inside a
    bucket (a permutation from ``seed``), each run to the walker free
    first."""
    walkers = header_int("kLongBlocks")
    rng = np.random.default_rng(seed)
    order = np.lexsort((rng.permutation(lst["length"].size), -lst["bucket"]))
    free = [(0, w) for w in range(walkers)]
    slots = np.zeros(walkers, np.int64)
    for i in order:
        t, w = heapq.heappop(free)
        slots[w] += lst["length"][i]
        heapq.heappush(free, (t + int(lst["length"][i]), w))
    return slots


def fixed_slots(lst: dict) -> np.ndarray:
    """The slots each walker takes when walker g walks the long runs of the
    tiles g, g + kLongBlocks, ... (the assignment the ticket replaced)."""
    walkers = header_int("kLongBlocks")
    return np.bincount(lst["tile"] % walkers, weights=lst["length"],
                       minlength=walkers).astype(np.int64)
