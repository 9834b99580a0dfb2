"""Key -> PS-shard partition policies for the sharded client.

The reference routes every pull/push key through a virtual-node consistent
hash ring (``consistent_hash.h:18-67``, consulted per key at ``pull.h:79-80``
and ``push.h:65-66``): each shard owns several pseudo-random points on a
2^64 ring and a key belongs to the first point clockwise of its hash.
Adding/removing one shard then remaps only ~1/n of the keyspace — the
property elastic resharding needs — where a modulo partition remaps ~all
of it.

TPU-side difference from the reference: routing is VECTORIZED.  Keys arrive
as an int64 batch, the hash is an 8-byte-lane FNV-1a over the whole array,
and ring lookup is one ``np.searchsorted`` — no per-key hashing on the hot
path (the reference hashes key-by-key under a read lock).
"""

from __future__ import annotations

import numpy as np

_FNV_OFFSET = np.uint64(0xCBF29CE484222325)
_FNV_PRIME = np.uint64(0x100000001B3)


def fnv1a64_bytes(data: bytes) -> int:
    """Scalar FNV-1a 64 (same constants as native/shm_kv.cpp) for vnode
    labels — off the hot path."""
    h = int(_FNV_OFFSET)
    for b in data:
        h = ((h ^ b) * int(_FNV_PRIME)) & 0xFFFFFFFFFFFFFFFF
    return h


def fnv1a64_keys(keys: np.ndarray) -> np.ndarray:
    """Vectorized FNV-1a 64 over each key's 8 little-endian bytes ->
    uint64 hash per key."""
    lanes = np.ascontiguousarray(keys, "<i8").view(np.uint8).reshape(-1, 8)
    h = np.full(len(lanes), _FNV_OFFSET, np.uint64)
    for i in range(8):
        h = (h ^ lanes[:, i].astype(np.uint64)) * _FNV_PRIME
    return h


def _resolve_members(n_shards, members):
    """Normalize the (n_shards, members) pair every policy accepts:
    ``members`` is the LIVE subset of stable shard ids (elastic membership);
    None means all of ``range(n_shards)`` — the static pre-elastic form."""
    if members is None:
        if n_shards is None:
            raise ValueError("need n_shards or members")
        members = range(n_shards)
    out = sorted({int(m) for m in members})
    if not out:
        raise ValueError("partition needs at least one member shard")
    if any(m < 0 for m in out):
        raise ValueError("shard ids must be >= 0")
    return out


class ModuloPartition:
    """Static ``key % n`` routing — uniform for folded ids, but a shard
    count change remaps ~the whole keyspace (no elastic story).  With a
    ``members`` subset it routes ``key % len(members)`` into the sorted
    member list — still non-elastic (membership change remaps ~all keys),
    kept only so both policies share the cluster-map interface."""

    name = "modulo"

    def __init__(self, n_shards: int = None, members=None):
        self.members = _resolve_members(n_shards, members)
        self.n_shards = (self.members[-1] + 1) if n_shards is None \
            else n_shards
        self._members_arr = np.array(self.members, np.int64)

    def shard_of(self, keys: np.ndarray) -> np.ndarray:
        k = np.asarray(keys, np.int64)
        if len(self.members) == self.n_shards and \
                self.members == list(range(self.n_shards)):
            # dense membership: the historical key % n mapping, unchanged
            return (k % self.n_shards).astype(np.int64)
        return self._members_arr[k % len(self.members)]


class RingPartition:
    """Virtual-node consistent-hash ring (consistent_hash.h:18-67; the
    reference plants ``VIRTUAL_NODE=5`` points per shard at
    ``consistent_hash.h:23-31``).  A key routes to the first vnode
    clockwise of its hash, wrapping past 2^64.

    Vnode labels are keyed by STABLE shard id, so the ring over live
    members ``{0, 2}`` is exactly the ring over ``{0, 1, 2}`` with shard
    1's arcs absorbed by their clockwise successors: removing a member
    moves ONLY that member's keys, adding one moves only the keys landing
    on the new member's arcs (~1/n) — the property elastic rebalancing
    relies on to bound row migration (docs/ELASTICITY.md)."""

    name = "ring"

    def __init__(self, n_shards: int = None, vnodes: int = 5, members=None):
        self.members = _resolve_members(n_shards, members)
        self.n_shards = (self.members[-1] + 1) if n_shards is None \
            else n_shards
        self.vnodes = vnodes
        points = [
            (fnv1a64_bytes(f"shard-{s}#vnode-{v}".encode()), s)
            for s in self.members
            for v in range(vnodes)
        ]
        points.sort()
        self._pos = np.array([p for p, _ in points], np.uint64)
        self._shard = np.array([s for _, s in points], np.int64)

    def shard_of(self, keys: np.ndarray) -> np.ndarray:
        h = fnv1a64_keys(np.asarray(keys, np.int64))
        idx = np.searchsorted(self._pos, h, side="left") % len(self._pos)
        return self._shard[idx]


def make_partition(name: str, n_shards: int = None, members=None,
                   vnodes: int = 5):
    """Build a key->shard policy over the live member set (None = all of
    ``range(n_shards)``, the static form every pre-elastic caller uses)."""
    if name == "modulo":
        return ModuloPartition(n_shards, members=members)
    if name == "ring":
        return RingPartition(n_shards, vnodes=vnodes, members=members)
    raise ValueError(f"unknown partition policy {name!r}")
